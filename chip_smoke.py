#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each one against its plain PyTorch version on the card, then drives the
port's main path (``swtorch align --strategy batch``) end to end:

0. card name and power limit, kernel build time, registers, and the
   instructions per cell of the DPX intrinsics (``cuobjdump``); K1's,
   K4's and K5's two forms in the built library: every s16x2 kernel runs
   the instruction of ``__viaddmax_s16x2_relu`` and spills nothing, and
   the ALU instructions per cell of both forms' inner loops at every L
   (K1, K4) and of K5's s16x2 row loop; K2's s16x2 kernel (every L) and
   K8's run that instruction too, and neither spills, nor K2's merge, K8's
   other two kernels and its finish, K9's two (one per tie order), K10's,
   or the twelve of K9 and K10 in one launch (``fill_walk_kernel``); the ALU
   instructions per cell of K2's s16x2 loop at every L; K3's s16x2
   kernel (every L) runs it and spills nothing, its diagonal loop's ALU
   instructions (a plain and an edge step) beside K1's (a plain step);
   K6's and K7's s16x2 kernels (every L,
   K6 masked or not, K7's A, B, D, E) run it and spill nothing, and K6's
   inner loop takes no more ALU instructions per cell than sweep_s16x2's
   (K4's) at L = 4, the bench's width; K1's and K4's striped s16x2 kernels
   (``lane_best_wide_s16x2_kernel``, ``score_grid_wide_s16x2_kernel``) run
   it and spill nothing, their stripe step's ALU instructions a cell beside
   the int32 striped kernels'; K3's and K8's wide s16x2 kernels
   (``band_wide_s16x2_kernel``, ``max_cells_wide_s16x2_kernel``) run it and
   spill nothing, their registers and loops' ALU instructions a cell
   printed; and the s16x2 kernels that share ``sweep_s16x2`` (K1, K2, K3,
   K4, and K1's, K2's and K4's striped ones) or the row step (K5, K8, and
   K5's wide one) have the parent trees' SASS (``KEPT_SASS``, compared
   where the toolkit is the one named there);
1. K1 (packed lane best) against its plain version, in both forms
   (``cuda_score.k1_form``): 512 reads x 256 RefSeq-shaped refs, every
   start lane, and the two forms timed on them in turns (int32, s16x2,
   s16x2, int32); 64 reads x 8 refs of 131,072 bp against the row-form
   recurrence; edge cases (empty reads, length-0 and length-1 refs,
   all-pad rows, 128- and 512-lane rows); the s16x2 form on an odd
   number of rows, on hand-packed pairs of rows with different segment
   layouts and at gap (and mismatch) -32,768; a 1,024 bp read equal to
   its ref at match 31 (31,744, s16x2) and 32 (int32);
2. K2 (per-lane argmax) against its plain version on the lanes the
   traceback reads, in its s16x2 form (in column segments where its plan
   splits), the s16x2 form as one segment and the int32 form: 2,000 reads
   x one 2 kb ref (the forms timed in turns) and 64 reads x one 131 kb ref
   (split into segments; each way timed, the segments at least 5x faster
   than one); 24 small cases (1-19 reads of every width, 1-3 refs,
   mismatch and gap 0); ties planted around the borders of K2's segments
   of a 131 kb ref, equal to plain (one diagonal loop over both 131 kb
   refs) and to where they were planted; 256 reads x a 0.95 Mb ref (the
   long-ref workload's winner), the s16x2 form equal to the int32 form,
   both timed in turns;
   K8 (the listing of every cell equal to a read's best) against its
   plain version on the reads K2 finds tied inside a DP row there: every
   count and cell equal, at 2 kb in both forms and as one segment, at
   131 kb split into column segments, as one segment and in the int32
   form, and at a capacity below the counts (the count exact, the slots
   distinct cells of the full listing); each form timed, and the listing
   kernel and its finish alone by events (``entry_events``); the finish against
   its plain version on shuffled slots at capacity 1,024 and 5,000; ties
   planted around the borders of K8's column segments of a 131 kb ref,
   listed once in both forms; and
   ``find_max_cells_batched`` of a read with 130,923 ties, all listed on
   the card (the host scan must not run); K9 (the traceback's fill with
   direction codes, and H where asked) and K10 (its walk) exact against
   their plain versions in both tie orders on 64 windowed jobs of 80-150
   bp x 512 columns, a full-fill chunk of reads x one 2 kb ref broadcast
   (H too, the cells from ``argwhere_rows``) and 4 windows of 1,025-2,048
   bp reads, each kernel timed against its bound; reads with 99-300 max
   cells x a 2 kb tandem repeat through the full-fill branch (past its
   first listing of 64, listed and walked again on the card) equal the
   oracle; K9 and K10 in one launch, each exact against its plain version
   in both tie orders: ``fill_walk`` (the windowed branch) on the 64
   windows (the main path's cell, a random one and none; shared-memory and
   scratch routes) and the 4
   long windows (scratch), ``fill_list`` (the full-fill branch, every
   output) on the 2 kb chunk and 512 reads x a 4 kb ref (a pair past
   capacity 64 and one of best 0 in each; the reference broadcast and per
   pair; both routes), each call's peak memory under the size of an H;
   each timed by events around the wrapper and around its kernel's
   launch alone (``entry_events``) against the plain version, K9 then K10
   as two launches (as the traceback ran them before) and the bound, the
   public wrapper and its route given in turns (one launch: the run fails
   if their two medians differ by more than 5%); ``sites_for_pair_long``
   (one read against a long reference, through K5, K8 and ``fill_walk``,
   each of which must launch) for a 150 bp read planted three times: x a
   2 kb ref equal to the oracle, with ``max_cells=`` too, and x a 131 kb
   ref equal to ``sites_for_ref_long_batched`` on the card;
3. correctness leg: ``cli.main(["align", ...])`` on a ~1 Mbp RefSeq-shaped
   corpus with a 512-read input (full-fill traceback) and a 2,000-read
   input (windowed traceback through K2); each report's max score and
   winners must equal those from totals computed by the row-form
   recurrence, and the sites of the first 16 reads must equal the oracle's;
4. scale leg: ``run_pipeline`` on a 64 Mbp RefSeq-shaped corpus plus
   8 refs of 131,072 bp, 512 reads; wall time, real GCUPS, parse time;
5. K3 (band lane best) against its plain version: 512 reads x 32 refs of
   500-4,000 bp cut into 1, 2 and 4 segments with random left columns,
   every start lane and every bnd_out lane, through the public wrapper
   (``cuda_score.k3_form``'s form, column pieces where
   ``band_segments`` cuts), and at one segment the int32 form and the
   16-bit form as one piece too; the same at the shard_seq leg's read
   shape (256 reads) on 8-16 kb segments, cut into pieces and as one;
   edge cases (both forms); both forms at the contract's edges (left
   column 0 and match x m, a scheme just inside and one just outside
   k3_form's rule); four chained K3 segments equal to K1 at 64 reads x 8
   refs of 131,072 bp, the second segment in pieces (both forms) equal to
   the int32 kernel as one piece; one 1 Mb segment among 8 kb ones (256 reads) equal to
   the int32 kernel; at one segment, 131 kb and the mixed launch the
   public wrapper, the 16-bit form as one piece and the int32 form timed
   in turns in one pass, each launch alone by events (``entry_events``);
6. ``swtorch align --strategy shard_seq`` on a 16 Mbp corpus of 8 kb-1 Mb
   refs with 256 reads, on the default mesh (every card): its report
   equals ``--strategy batch``'s apart from the time line, its winners'
   totals equal the row-form recurrence, every K3 launch takes the
   16-bit form, and ``SeqParallelBackend`` on a 4-entry mesh of this card
   gives batch's totals; K8 must launch in the two runs (the 1 Mb
   winner's tied reads); one ``_band_ring`` call, every upload before
   it, runs under ``torch.cuda.set_sync_debug_mode("error")`` and gives
   batch's totals;
7. ``--strategy shard_refs`` and ``shard_reads`` on the phase-3 corpus:
   reports equal to batch's apart from the time line; a (2, 2) mesh of
   this card gives batch's totals;
8. K4 (wavefront score grid) and K5 (row form), each in both forms
   (``cuda_score.k1_form``), against their plain versions: 512 reads x 64
   refs of 500-4,000 bp (reads in 256 lanes, and again at the reads'
   longest, 150 lanes), every pair, each also equal to the other; 64
   reads x 2 refs of 131,072 bp (K4) and 16 reads x one (K5, its
   reference split into column segments and as one segment) against the
   row-form recurrence; each kernel's two forms timed in turns (int32,
   s16x2, s16x2, int32) at 256 lanes, 150 lanes and 131 kb; the s16x2
   forms on an odd number of reads, at gap (and mismatch) -32,768, and a
   1,024 bp read equal to its ref at match 31 (31,744, s16x2) and 32
   (int32); edge cases (a block of 8 reads with empty and 1 bp reads,
   0/1 bp refs, reads of 1,024 bp); K4's ``window_mode='carry'`` and
   ``state_dtype`` give the same grid;
   ``lane_best_packed`` in every TPU window mode equals K1 at the start
   lanes;
9. the unpacked and row paths end to end: ``run_pipeline`` with
   ``pack_reads=False`` on the phase-4 scale corpus (report equal to
   phase 4's apart from the time line; wall, real GCUPS) and with
   ``kernel='row'`` on the phase-3 corpus (reports equal to phase 3's);
   ``ShardedBackend`` with each on a (2, 2) mesh of this card gives
   batch's totals;
10. ``swtorch scaling --axis refs`` (512 reads of 128 bp x 512 refs of
    4,096 bp, through K4; on 1, 2 and 4 cards where the host has four)
    and ``--axis seq``; the refs totals of a subset of refs equal the
    row-form recurrence;
11. K6 (step chain) against its plain version, each call in the form
    ``cuda_score.k6_form`` gives: the JAX microbench's rows (no start bit,
    int32) at 512 x 128 and 248 x 256 lanes, 131,072 steps, unroll 64,
    with and without the moving boundary, and the public wrapper's
    lane-0 read timed against the int32 form given; the bench's rows
    (lane 0 a start, s16x2) at ``bench.roofline_rows``; the two forms
    timed in turns (int32, s16x2, s16x2, int32) at 512 and at the
    card-filling rows, each form's result held; the s16x2 rate at 8 x SMs
    x w rows for w = 1-32 (no w may beat the bench's by more than 5%);
    the steps bound's edge (a row at 32,767 in s16x2, two steps more in
    int32); small cases in both forms (8 and 7 rows of 32-1,024 lanes,
    odd unroll, start lanes, masked or not);
12. K7 (packed step variants A-E) against its plain version at 248 rows
    of 256 lanes x 64 refs of 1,024 bp and in small cases of odd and
    even row counts, A, B, D and E in both forms (s16x2 by the rule),
    C in int32; each variant's two forms timed in turns at the first
    shape; the suffix max of E equals A;
13. the port's bench (``bench.run_bench``, one pass per leg, the e2e leg
    at 64 reads and readscale at 5,000: parity against the oracle, the
    smoke of every kernel, the line's keys; K4 on the kernel leg and K6
    on the roofline leg only in s16x2, and ``kernel_pct_roofline`` at most
    100%) and the two experiments at reduced sizes;
14. long reads: K1-K5 on rows (reads) of 1,025, 2,048, 4,096 and 16,384
    lanes, swept in stripes of 512, against their plain versions (reads
    over every stripe, starting on stripe boundaries and crossing them;
    K3 with random left columns, and chained over 2 and 4 segments equal
    to K1; K5 against K4's plain version, its contract); every K1, K2 and
    K4 call in ``cuda_score.k1k4_form``'s form and every K5 call in
    ``cuda_score.k5_form``'s, the s16x2 wide form equal to the int32 one
    at 1,025-4,096 lanes and at 16,384 (K1 on reads of at most 6,553 bp,
    its longest given; K1, K2, K4 and K5 at match 1), K2's s16x2 form
    equal to plain on every lane (its int32 form, and its equality with
    it, on the traceback's lanes); at 2,048 lanes each again with a carry
    budget of 1, every launch then run in parts of one block (four rows,
    eight in the s16x2 forms' pairs, a pair in K2's), equal to the one
    launch on every lane; K2's s16x2 form in column segments (reads of
    1,025 and 2,048 positions against 20 kb and 40 kb of a genome, which
    its plan cuts) equal to plain on every lane and to the int32 form, at the
    default carry budget and at 1; K3's two wide forms (``k3_form``, at
    4,096 lanes on reads of at most 3,276 bp, the longest given) and K8's
    (``k5_form``) against plain and each other at 1,025-4,096 positions,
    and cut into column pieces (segments) against whole at 45 kb and 131
    kb (ties planted at K8's segment borders); K1 at 2,048
    lanes against one 131,072 bp ref and the row-form recurrence; K8
    against its plain version on reads of 1,025-8,000 bp and a repeat;
    K1's, K2's, K3's, K4's, K5's and K8's two wide forms at 4,096 lanes in
    turns by events (the s16x2 one must be the faster), and K3 on a 1 Mb
    segment and K8 on a tied 2,048 bp read x 131 kb, each cut against
    whole; K1's wide launches of few rows (``k1_few_wide_rows``: 1 int32
    row, 1 and 3 s16x2 pairs, 8 rows with the last all-pad, and 5 rows
    and 5 pairs as one launch and in parts, against plain; the long-read
    cell's lone 8,039 bp int32 row against the same row padded to 8 rows
    by events, at most half its time); then ``swtorch align`` with batch, wavefront, shard_refs,
    shard_reads and shard_seq, and ``run_pipeline`` with
    ``pack_reads=False`` and ``kernel='row'``, on 128 reads (8 of
    1,025-8,000 bp) x 64 refs: reports equal, the winners' totals equal
    the row-form recurrence, every site equal to the per-read
    recomputation, every K1, K2, K4 and K5 launch in its rule's form (K1
    in both: the 8,000 bp read alone in an int32 row, the other reads in
    s16x2 pairs; K2 int32, every read padded to 8,000); and ``swtorch align --strategy batch``, ``wavefront`` with
    ``pack_reads=False`` and ``kernel='row'`` on the same reads without
    the 8,000 bp one (the batch run's winners through the windowed
    traceback, so K2 pads every read to 6,000): K1's, K2's, K4's and K5's
    wide launches in s16x2, the reports equal to the same runs with the
    rules giving int32 past 1,024 lanes; and ``swtorch align`` with batch
    and shard_seq on 64 reads (four of 1,025-3,000 bp, a 2,000 bp one
    twice in a 48 kb winner) x refs of 9-48 kb: K3's and K8's launches
    past one pass in s16x2 and cut into pieces, the reports equal to each
    other and to shard_seq with ``k3_form`` giving int32 and batch with
    K8's rule ``k1_form``;
15. the rest of the CLI, multi-host runs and the dry run: ``swtorch gen``
    writes the read_num, read_len and ref_len sweeps at ``--scale 1.0``
    and ref_num cut to ``--scale`` ``REF_NUM_SCALE`` (9 of its 28 dirs);
    ``swtorch info`` on the ref_len tree with ``--threads`` 1 and 8 writes
    the same bytes; ``swtorch bench --strategy batch`` over the four
    sweeps (every case a report and a time, the summary files, K1
    launched); ``swtorch diff`` batch against shard_seq on the phase-3
    corpus (identical, exit 0), serial against batch on a tiny corpus
    (identical) and with batch's report edited (DIVERGED, exit 1);
    ``run_multihost_pipeline`` in two processes on the card over gloo with
    a ``file://`` rendezvous, the phase-3 corpus in two reference files
    (process 0's reports equal phase 3's apart from the time line, K1
    launched in both; resumed from the journals, neither scores); and
    ``dryrun.dryrun_multichip(4)`` on a (2, 2) mesh of the card.

Each phase ends with a line of its wall seconds, and ``[end]`` lists
them all.  Launch counts are reset just before each main-path leg and read just
after it, K1's, K2's, K3's, K4's, K5's, K6's, K7's and K8's per form too
(``cuda_score.K1_FORMS`` .. ``K8_FORMS``): every K3 launch of phase 6
takes the s16x2 form, every K1 launch of phases
3-4, 7 and 13, every K2 launch of phases 3-4 and 13, every K4 launch of
phases 9, 10 and 13, every K5 launch of phase 9 and every K6 launch of
the bench's roofline leg must take the s16x2 form; in 14 every K1, K2
and K4 launch takes ``k1k4_form``'s form and every K5 launch
``k5_form``'s (the wide ones of the 6,000 bp corpus s16x2); K6
and K7 must launch in both forms over the legs.  The legs:
phases 3-4 (batch; K1
and K2 must launch, and the traceback through ``fill_list`` or
``fill_walk``, never through K9's and K10's separate launches), 6
(shard_seq and batch; K3 and K8, and the traceback as in 3-4, in each),
7 (shard_refs and shard_reads; K1), 9 (unpacked and row paths; K4 and
K5), 10 (scaling; K4), each bench leg of 13 (K4 on the kernel leg, K1 on
the path legs, K2 in s16x2 on the long-ref leg, K6 on the roofline leg), each
experiment (K6, K7), the long-read paths of 14 (K1-K5, the traceback as
in 3-4) and its three runs on the 6,000 bp corpus (K1, K2, K4, K5), and in 15 ``swtorch bench`` (K1, the traceback as in 3-4), each
``swtorch diff`` (K1; K3 against shard_seq), each process's two runs of
the multi-host leg (read from its output) and the dry run (K4); over all legs both ``fill_list`` and ``fill_walk`` must launch.
A kernel's ``launches`` in the summary is its sum over those legs.

Each kernel's ``bound_ms`` is the larger of two times.  One is its DP
cells x INSTR_PER_CELL over the SMs' instruction rate (4 schedulers x 32
threads per clock x SMs x the max SM clock ``nvidia-smi`` reports): the
fewest instructions the recurrence needs, the same for every kernel,
which phase 0 checks against the SASS of the DPX intrinsics.  The other
is its bytes (inputs read once, outputs written once) over 3.35 TB/s.
The script fails if a kernel runs faster than its bound (``wide_*``
keys: the same at 4,096 lanes).  K9's cells are every cell of its
planes and its bytes the codes (and H) it writes; K10 does no DP cell,
its bytes the cells, a byte per step and its outputs.  ``fill_list``
counts every cell of its planes and its inputs and five outputs;
``fill_walk`` each window's cells down to its cell's row and its inputs,
begins and codes; their ``ms`` is the kernel alone (events around its C
entry's launch, ``entry_events``), their ``wrapper_ms`` the wrapper's by
events.  The script reads no ``torch.profiler`` record: a run can lose
them at random (ROADMAP F10).  No single PyTorch call computes
any of the twelve functions, so ``library_ms`` is null.  Any failure raises and exits non-zero.  The second-to-last line
is the kernels' JSON summary; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
PARAMS = (5, -3, -4)
LONG_N = 131_072
# Lanes per thread of the kernels (csrc/wavefront.cuh SWT_FOR_EACH_L).
_LANES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Instructions an SM starts per clock: 4 schedulers x one warp instruction
# of 32 threads.
INSTR_PER_SM_CLOCK = 4 * 32
# Fewest instructions per DP cell of max(0, H[i-1][j-1] + sub,
# max(H[i-1][j], H[i][j-1]) + gap) on sm_90: two 16-bit cells per register
# and three DPX instructions per register (see PROBE_SRC); the choice of
# the substitution pair can be hoisted out of the per-cell work, so it is
# not counted.  The same for every kernel, whatever it executes.
INSTR_PER_CELL = 1.5

# One register (two 16-bit cells) of the recurrence, h = max(0, D + S,
# U + G, L + G), in three forms built from CUDA's DPX and SIMD intrinsics,
# each eight times on distinct operands so nothing folds.
_PROBE_KERNEL = r"""
extern "C" __global__ void NAME(const unsigned* __restrict__ in, unsigned* __restrict__ out) {
  const unsigned G = in[0];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned D = in[1 + 4 * k], S = in[2 + 4 * k], U = in[3 + 4 * k], L = in[4 + 4 * k];
    out[k] = EXPR;
  }
}
"""
PROBE_SRC = "#include <cuda_runtime.h>\n" + "".join(
    _PROBE_KERNEL.replace("NAME", name).replace("EXPR", expr)
    for name, expr in (
        ("dpx_chain", "__viaddmax_s16x2(D, S, __viaddmax_s16x2(U, G, __viaddmax_s16x2_relu(L, G, 0u)))"),
        ("dpx_add_first", "__viaddmax_s16x2_relu(L, G, __viaddmax_s16x2(U, G, __vadd2(D, S)))"),
        ("dpx_max_first", "__viaddmax_s16x2_relu(__vmaxs2(U, L), G, __vadd2(D, S))"),
        # __viaddmax_s16x2_relu alone: its mnemonic, which K1's s16x2
        # form must contain (not a form of the recurrence).
        ("dpx_relu", "__viaddmax_s16x2_relu(U, G, L)"),
    )
)
# One process of phase 15's two-process run: run_multihost_pipeline on the
# card over a gloo group with a file:// rendezvous, then again resuming
# from the journals; after each run one "LAUNCHES {...}" line of its
# kernel launches and forms.
_MULTIHOST_DRIVER = r"""
import json, sys
import torch
import torch.distributed as dist
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.parallel.multihost import HostConfig, run_multihost_pipeline
pid, refs, inputs, out, rdv = int(sys.argv[1]), *sys.argv[2:6]
host = HostConfig(num_processes=2, process_id=pid, init_method="file://" + rdv)
host.initialize()
config = AlignConfig(ref_dir=refs, in_dir=inputs, out_dir=out, strategy="batch")
for resume in (False, True):
    cuda_score.reset_launches()
    paths = run_multihost_pipeline(config, host, resume=resume, device="cuda")
    torch.cuda.synchronize()
    forms = {k: dict(getattr(cuda_score, k + "_FORMS")) for k in ("K1", "K2", "K3", "K4", "K5", "K8")}
    print("LAUNCHES " + json.dumps({"resume": resume, "paths": paths, "launches": dict(cuda_score.LAUNCHES),
                                    "forms": forms}), flush=True)
dist.destroy_process_group()
"""
# ref_num's sweep at scale 1.0 is 28 dirs of up to 40,000 refs (169 Mbp of
# Python-drawn text); phase 15 writes its first 9 dirs (1-2,000 refs).
REF_NUM_SCALE = 0.33

# K1's and K4's striped kernels, int32 and s16x2 (one instantiation each,
# L = kStripeL).
WIDE_KERNELS = ("lane_best_wide_kernel", "lane_best_wide_s16x2_kernel", "score_grid_wide_kernel",
                "score_grid_wide_s16x2_kernel")
# K5's and K2's 16-bit kernels for reads wider than one pass.
WIDE16_ROW_ARGMAX = ("score_row_wide_s16x2_kernel", "argmax_wide_s16x2_kernel")
# K3's and K8's 16-bit kernels for rows (reads) wider than one pass.
WIDE16_BAND_CELLS = ("band_wide_s16x2_kernel", "max_cells_wide_s16x2_kernel")
# The s16x2 kernels that share sweep_s16x2 (K1-K4's one-pass kernels,
# K1's, K2's and K4's striped ones) or the row step (K5's and K8's
# one-pass kernels, K5's wide one), as the commit before the striped
# s16x2 forms built the one-pass K1-K4 kernels, the commit before K2's and
# K5's wide forms built K1's and K4's striped ones and the one-pass K5,
# and the commit before K3's and K8's wide forms built the rest, but K1's
# striped one, as the commit that sized K1's wide blocks to their rows
# built it (its pair index reads the block's warps, no longer kWarps):
# sass_digests' {kernel: (functions, digest)} and the toolkit that built
# them.
KEPT_SASS = {
    "nvcc": "Build cuda_12.9.r12.9/compiler.36037853_0",
    "kernels": {
        "argmax_s16x2_kernel": (12, "ea1d0a0c79ea822e"),
        "band_s16x2_kernel": (12, "83f84d8dcd7ef9cc"),
        "lane_best_s16x2_kernel": (12, "55a50e233ea8841a"),
        "score_grid_s16x2_kernel": (12, "7c63227b398f92a7"),
        "score_row_s16x2_kernel": (1, "fafdfdb02684b75d"),
        "lane_best_wide_s16x2_kernel": (1, "40713eb2a19f55f8"),
        "score_grid_wide_s16x2_kernel": (1, "921cd39e73354478"),
        "max_cells_s16x2_kernel": (1, "8f9dadcd4402db97"),
        "argmax_wide_s16x2_kernel": (1, "6c481f549c1b8042"),
        "score_row_wide_s16x2_kernel": (1, "8323adcf8b4894d9"),
    },
}

_NOT_ALU = ("LDG", "STG", "LDC", "ULDC", "LDS", "STS", "EXIT", "BRA", "NOP", "S2R", "S2UR", "MOV", "IMAD.MOV")


@functools.lru_cache(maxsize=None)
def sass_text(cuobjdump: str, path: str) -> str:
    """``cuobjdump -sass`` of a cubin or shared library (read once)."""
    return subprocess.run([cuobjdump, "-sass", path], check=True, capture_output=True, text=True).stdout


def sass_functions(cuobjdump: str, path: str):
    """{function: [(address, opcode, branch target or None), ...]} of a
    cubin or shared library, read back with ``cuobjdump -sass``."""
    text = sass_text(cuobjdump, path)
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        instrs, labels = [], {}
        for line in body.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                labels[label.group(1)] = len(instrs)
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Za-z0-9_.]*)([^;]*);", line)
            if ins:
                target = re.search(r"\(?(\.L_x_\d+)\)?|0x([0-9a-f]+)", ins.group(3)) if ins.group(2).startswith("BRA") else None
                instrs.append([int(ins.group(1), 16), ins.group(2), target and (target.group(1) or int(target.group(2), 16))])
        for ins in instrs:  # label targets to addresses
            if isinstance(ins[2], str):
                ins[2] = instrs[labels[ins[2]]][0] if labels.get(ins[2], len(instrs)) < len(instrs) else None
        out[name] = [tuple(ins) for ins in instrs]
    return out


def kernel_identifier(mangled: str):
    """The kernel's identifier in a mangled name (the shortest tail of the
    name up to ``_kernel`` that its length in digits precedes), or None."""
    m = re.match(r"(.*?_kernel)(?=[IE])", mangled)
    if not m:
        return None
    head = m.group(1)
    return next((head[-n:] for n in range(len("_kernel"), len(head) + 1) if head[:-n].endswith(str(n))), None)


def sass_digests(cuobjdump: str, path: str, pattern: str = r".*"):
    """{kernel: (functions, digest)} of the kernels of a library whose
    identifier (:func:`kernel_identifier`) matches ``pattern``: a SHA-256
    over the SASS text of each kernel's functions (its instantiations) in
    name order, addresses and encodings left out, so that two builds of
    the same kernels compare equal exactly when their instructions are the
    same."""
    text = sass_text(cuobjdump, path)
    bodies = collections.defaultdict(dict)
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        kernel = kernel_identifier(name)
        if kernel and re.fullmatch(pattern, kernel):
            lines = [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body)]
            bodies[kernel][name] = "\n".join(lines)
    return {kernel: (len(fns), hashlib.sha256("\n\n".join(fns[k] for k in sorted(fns)).encode()).hexdigest()[:16])
            for kernel, fns in bodies.items()}


def inner_loop_alu(instrs):
    """The ALU opcodes of a sweep's inner loop: the innermost backward
    branch whose body clamps at 0 (a ``.RELU`` instruction); memory,
    control and move instructions not counted."""
    relu = [addr for addr, op, _ in instrs if op.endswith(".RELU")]  # in address order
    loops = [(target, addr) for addr, op, target in instrs
             if target is not None and target <= addr
             and bisect.bisect_left(relu, target) < bisect.bisect_right(relu, addr)]
    fail_unless(loops, "no inner loop with a clamp at 0 in the SASS")
    lo, hi = min(loops, key=lambda loop: loop[1] - loop[0])
    return [op for a, op, _ in instrs if lo <= a <= hi and not op.startswith(_NOT_ALU)]


def inner_loop_per_cell(instrs, cells_per_relu: int) -> float:
    """ALU instructions per DP cell of a diagonal sweep's inner loop
    (:func:`inner_loop_alu`), cells = its ``.RELU`` instructions (one per
    cell of the int32 form and one per register of two cells of the
    s16x2 form) x ``cells_per_relu``."""
    alu = inner_loop_alu(instrs)
    return len(alu) / (sum(op.endswith(".RELU") for op in alu) * cells_per_relu)


def probe_instructions(nvcc: str, work: str):
    """{probe: (ALU instructions per register of two cells, mnemonics)}
    for the forms of PROBE_SRC compiled for sm_90a and read back with
    cuobjdump (memory, control and move instructions not counted)."""
    src = os.path.join(work, "probe.cu")
    cubin = os.path.join(work, "probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    proc = subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", cubin, src],
                          capture_output=True, text=True)
    fail_unless(proc.returncode == 0, f"the DPX probe does not compile:\n{proc.stdout}{proc.stderr}")
    out = {}
    for name, instrs in sass_functions(os.path.join(os.path.dirname(nvcc), "cuobjdump"), cubin).items():
        alu = [op for _, op, _ in instrs if not op.startswith(_NOT_ALU)]
        out[name] = (len(alu) / 8, sorted(set(alu)))
    return out


def bound(cells: int, nbytes: int, sms: int, clock_mhz: float):
    """(least ms, "operations" or "bytes") for this work on the card: the
    larger of the cells' instructions at the SMs' instruction rate and the bytes
    (inputs read once, outputs written once) at the memory rate."""
    ops_ms = cells * INSTR_PER_CELL / (sms * INSTR_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def stripped(path):
    """A report's lines without its Execution Time line."""
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


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


def in_turns(fn, iters: int):
    """A kernel's two forms on the same inputs, fn(form) for form "int32"
    and "s16x2": ({form: [ms, ms]} timed in turns int32, s16x2, s16x2,
    int32; {form: fn(form)} of one call each before the timing), so that
    the caller holds both forms' results as well as their times."""
    outs = {form: fn(form) for form in ("int32", "s16x2")}
    turns = collections.defaultdict(list)
    for form in ("int32", "s16x2", "s16x2", "int32"):
        turns[form].append(cuda_ms(lambda: fn(form), iters))
    return turns, outs


# Clock cycles of the spin kernel that entry_events puts before each timed
# launch (about 50 us on an H100, more than the host takes to launch).
SPIN_CYCLES = 100_000


@contextlib.contextmanager
def entry_events(lib, names):
    """Times every call of the kernel library's C entries ``names`` made
    inside the block by CUDA events around the call, after a spin kernel
    (``torch.cuda._sleep``) that keeps the card busy while the host makes
    the launch, so that the two events hold the launch alone: not the
    wrapper's allocations, zeroing or host syncs, and not the host's time.
    Yields the list to which each call appends (entry, start, end)."""
    import torch

    log = []
    saved = {name: getattr(lib, name) for name in names}

    def bracketed(name, entry):
        def call(*args):
            torch.cuda._sleep(SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = entry(*args)
            end.record()
            log.append((name, start, end))
            return rc
        return call

    for name, entry in saved.items():
        setattr(lib, name, bracketed(name, entry))
    try:
        yield log
    finally:
        for name, entry in saved.items():
            setattr(lib, name, entry)


def register_summary(ptxas_log: str):
    """{kernel: ["[L=<lanes>:]<registers>r[+<spill bytes>s]", ...]} from nvcc's -Xptxas -v log."""
    out, current = collections.defaultdict(list), None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']*?_kernel)(?:ILi(\d+)E)?", line)
        if m:
            # The kernel's identifier: the shortest tail of the mangled
            # name that its length in digits precedes.
            head = m.group(1)
            n = next(n for n in range(len("_kernel"), len(head) + 1) if head[:-n].endswith(str(n)))
            current = [head[-n:], m.group(2), 0]
        elif current and "bytes spill stores" in line:
            current[2] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lanes = f"L={current[1]}:" if current[1] else ""
            out[current[0]].append(f"{lanes}{regs}r" + (f"+{current[2]}s" if current[2] else ""))
            current = None
    return dict(out)


class PhaseClock:
    """Wall seconds of each phase: ``lap(k)`` adds the seconds since the
    last lap to phase k, ``done(k)`` also prints the phase's total."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def lap(self, phase: int) -> None:
        now = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) + now - self._t
        self._t = now

    def done(self, phase: int) -> None:
        self.lap(phase)
        print(f"[{phase}] phase {phase} took {self.seconds[phase]:.1f} s", flush=True)


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


def k1_few_wide_rows(dev, sms: int, clock_mhz: float) -> str:
    """K1's striped launches of few rows, as the batch backend's packs of
    one form give them (one int32 row; s16x2 pairs; no row past the last
    read but where a form pairs): blocks of as many warps as the rows need.
    Against the plain version at every start lane (2,048-lane rows at
    match 20, where reads past 1,638 bp take int32): 1 int32 row, 1 and 3
    s16x2 pairs, 1 row in the s16x2 form (its pair's other half past the
    rows), 8 int32 rows with the last all-pad, and 5 int32 rows and 5
    s16x2 pairs (a block of four and a block of one) as one launch and in
    parts of one block (carry budget 1).  Then by events in turns at the
    long-read cell's 8,192-lane rows (scheme 5/-3/-4, 2,048 refs of
    500-4,000 bp): one 8,039 bp read as its own int32 row against the same
    row padded to 8 rows, which must take at least twice as long, and the
    cell's other 19 reads in 3 s16x2 pairs against the same padded to 8
    rows.
    Returns the line to print."""
    import torch

    from sparksmithwaterman_tpu_torch.io.fasta import encode_concat
    from sparksmithwaterman_tpu_torch.ops import cuda_score
    from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best

    rng = np.random.default_rng(SEED + 25)  # its own stream: the other inputs stay as they were
    genome = rand_seqs(rng, [20_000])[0]

    def piece(n):
        o = int(rng.integers(0, len(genome) - n + 1))
        return genome[o : o + n]

    def refs_on_card(refs):
        flat, lens = encode_concat(refs)
        order = np.argsort(-lens, kind="stable")
        offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
        return (torch.from_numpy(flat).to(dev), torch.from_numpy(lens[order].astype(np.int32)).to(dev),
                torch.from_numpy(offs[order]).to(dev))

    def k1(reads, m, ref_args, params, row_multiple):
        """(K1's call in its rule's form, the packed rows, the start lanes)."""
        packed, start = pack_reads(reads, m, row_multiple)
        packed = torch.from_numpy(packed).to(dev)
        flat, lens, offs = ref_args
        longest = max(map(len, reads))
        return (lambda: cuda_score.lane_best_packed_varlen(packed, flat, lens, *params, offsets=offs, longest=longest),
                packed, start)

    params = (20, -3, -4)  # 16 bits up to 1,638 bp
    ref_args = refs_on_card([piece(600), piece(1), piece(250), "", piece(90)])
    cases = {
        "1 int32 row": ([1700, 300], 1, "int32", 1),
        "1 s16x2 pair": ([1600, 1200, 400], 2, "s16x2", 2),
        "1 s16x2 row": ([1600], 1, "s16x2", 1),
        "3 s16x2 pairs": ([1600, 1500, 1400, 1300, 1200, 1100], 2, "s16x2", 6),
        "8 int32 rows, the last all-pad": ([1700, 1650, 1640, 1630, 1620, 1610, 1600], 8, "int32", 8),
        "5 int32 rows": ([1700, 1600, 1500, 1400, 1300], 1, "int32", 5),
        "5 s16x2 pairs": ([1600, 1550, 1500, 1450, 1400, 1350, 1300, 1250, 1200, 1150], 2, "s16x2", 10),
    }
    checked = []
    for name, (lens, multiple, form, rows) in cases.items():
        reads = [piece(n) for n in lens]
        fn, packed, start = k1(reads, 2048, ref_args, params, multiple)
        fail_unless(packed.shape[0] == rows and cuda_score.k1k4_form(2048, *params, longest=max(lens)) == form,
                    f"K1 few wide rows, {name}: {packed.shape[0]} rows, form "
                    f"{cuda_score.k1k4_form(2048, *params, longest=max(lens))}")
        before = dict(cuda_score.K1_FORMS)
        got = read_best(fn(), start)
        fail_unless(cuda_score.K1_FORMS[form] == before[form] + 1, f"K1 few wide rows, {name}: not in {form}")
        want = read_best(cuda_score.lane_best_packed_varlen_plain(packed, *ref_args[:2], *params, ref_args[2]), start)
        fail_unless(torch.equal(got, want), f"K1 few wide rows, {name}: differs from the plain version")
        if rows == 5 or rows == 10:
            budget, cuda_score.CARRY_BUDGET = cuda_score.CARRY_BUDGET, 1
            try:
                parts = read_best(fn(), start)
            finally:
                cuda_score.CARRY_BUDGET = budget
            fail_unless(torch.equal(parts, want), f"K1 few wide rows, {name}: in parts of one block differs")
        checked.append(f"{name} (best {int(want.max())})")

    # The long-read cell's shape, by events in turns.
    long_lens = [1067, 1154, 1243, 1337, 1435, 1538, 1649, 1768, 1897, 2038, 2195, 2371, 2571, 2804, 3082, 3425,
                 3871, 4497, 5518, 8039]
    refs = [piece(int(n)) for n in rng.integers(500, 4001, 2048)]
    ref_args = refs_on_card(refs)
    ref_bp = sum(map(len, refs))
    reads = [piece(n) for n in long_lens]
    pairs = {form: tuple(k1(reads[sl], 8192, ref_args, (5, -3, -4), multiple) for multiple in (own, 8))
             for form, sl, own in (("int32", slice(19, None), 1), ("s16x2", slice(None, 19), 2))}
    times = {}
    for form, ((fn, packed, start), (fn_pad, packed_pad, start_pad)) in pairs.items():
        fail_unless(torch.equal(read_best(fn(), start), read_best(fn_pad(), start_pad)),
                    f"K1 at 8,192 lanes in {form}: the padded rows change the reads' bests")
        turns = [cuda_ms(f, 2) for f in (fn, fn_pad, fn_pad, fn)]
        times[form] = (packed.shape[0], packed_pad.shape[0], turns)
    t32 = times["int32"][2]
    fail_unless(2 * max(t32[0], t32[3]) <= min(t32[1], t32[2]),
                f"K1 at 8,192 lanes: one int32 row takes {t32[0]:.3f}, {t32[3]:.3f} ms, more than half of the same row "
                f"padded to 8 ({t32[1]:.3f}, {t32[2]:.3f} ms)")
    timed = []
    for form, (rows, rows_pad, turns) in times.items():
        cells = sum(long_lens[19:] if form == "int32" else long_lens[:19]) * ref_bp
        least = bound(cells, 0, sms, clock_mhz)[0]
        own, pad = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        timed.append(f"{form} {rows} rows against {rows_pad} in turns " + ", ".join(f"{t:.3f}" for t in turns)
                     + f" ms ({own / pad:.3f}x; {cells / own / 1e6:.1f} GCUPS, {100 * least / own:.1f}% of the bound)")
    return ("K1 wide launches of few rows, equal to the plain version at every start lane: " + "; ".join(checked)
            + f". At 8,192 lanes x {len(refs)} refs ({ref_bp} bp), by events: " + "; ".join(timed))


def main() -> int:
    import torch

    t_start = time.perf_counter()
    clock = PhaseClock()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparksmithwaterman_tpu_torch import bench, cli
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.core import oracle
    from sparksmithwaterman_tpu_torch.dryrun import dryrun_multichip
    from sparksmithwaterman_tpu_torch.io import get_reads, get_ref_seqs, iter_files
    from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
    from sparksmithwaterman_tpu_torch.metrics import diff as diff_module
    from sparksmithwaterman_tpu_torch.metrics.engineer_data import long_ref_corpus, reads_file, refseq_like, scale_corpus
    from sparksmithwaterman_tpu_torch.metrics.scaling import workload
    from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    from sparksmithwaterman_tpu_torch.ops import _cuda, cuda_score
    from sparksmithwaterman_tpu_torch.ops import longseq
    from sparksmithwaterman_tpu_torch.ops.device_traceback import path_cap
    from sparksmithwaterman_tpu_torch.ops.longseq import find_max_cells_batched, sites_for_ref_long_batched
    from sparksmithwaterman_tpu_torch.ops.microbench import roofline_reads
    from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads, read_best
    from sparksmithwaterman_tpu_torch.ops.recurrence import score_grid
    from sparksmithwaterman_tpu_torch.parallel import SeqParallelBackend, ShardedBackend, build_mesh, sharded_totals
    from sparksmithwaterman_tpu_torch.parallel.multihost import shard_manifest
    from sparksmithwaterman_tpu_torch.parallel.seqparallel import _band_ring, _segment_tables, _upload_refs

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    print(f"[0] card: {bench.card_name(dev)}")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instr_rate = sms * INSTR_PER_SM_CLOCK * clock_mhz * 1e6
    print(f"[0] {sms} SMs, max SM clock {clock_mhz:.0f} MHz: instruction rate {instr_rate / 1e12:.2f} T instructions/s; "
          f"bound {INSTR_PER_CELL} instructions per DP cell = {instr_rate / INSTR_PER_CELL / 1e9:.1f} GCUPS")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"[0] kernel library {os.path.basename(_cuda.build_info['path'])}: nvcc {_cuda.build_info['seconds']:.2f} s"
          f" (load total {time.perf_counter() - t0:.2f} s)", flush=True)
    for name, widths in register_summary(_cuda.build_info["log"]).items():
        order = sorted(widths, key=lambda w: int(w[2:].split(":")[0]) if w.startswith("L=") else 0)
        print(f"[0] ptxas {name}: {' '.join(order)}")
    nvcc = _cuda._nvcc()
    with tempfile.TemporaryDirectory(prefix="swtorch_probe_") as work:
        probes = probe_instructions(nvcc, work)
    relu_ops = probes.pop("dpx_relu")[1]
    fail_unless(len(relu_ops) == 1, f"__viaddmax_s16x2_relu compiles to {relu_ops}, not one instruction")
    for name, (per_register, mnemonics) in probes.items():
        print(f"[0] SASS {name}: {per_register:g} instructions per register of two cells ({', '.join(mnemonics)})")
    fewest = min(per_register for per_register, _ in probes.values()) / 2
    fail_unless(fewest >= INSTR_PER_CELL,
                f"a DPX form takes {fewest} instructions per cell, under the bound's {INSTR_PER_CELL}")
    # K1's and K4's two forms in the built library: every s16x2 kernel must
    # run the DPX instruction of __viaddmax_s16x2_relu and spill nothing.
    lib_sass = sass_functions(os.path.join(os.path.dirname(nvcc), "cuobjdump"), _cuda.build_info["path"])
    s16x2_cell = {}  # K1's and K4's s16x2 inner loops: ALU instructions per cell at each L
    for k, name in (("K1", "lane_best"), ("K4", "score_grid")):
        per_cell = collections.defaultdict(dict)
        s16x2_cell[k] = per_cell["s16x2"]
        for fname, instrs in lib_sass.items():
            hit = re.search(rf"\d({name}_s16x2_kernel|{name}_kernel)ILi(\d+)E", fname)
            if hit:
                form = "s16x2" if "s16x2" in hit.group(1) else "int32"
                ops = {op for _, op, _ in instrs}
                fail_unless(form == "int32" or relu_ops[0] in ops,
                            f"{k}'s s16x2 kernel at L={hit.group(2)} lacks {relu_ops[0]}")
                per_cell[form][int(hit.group(2))] = inner_loop_per_cell(instrs, 2 if form == "s16x2" else 1)
        fail_unless(sorted(per_cell["s16x2"]) == sorted(per_cell["int32"]) == list(_LANES),
                    f"{k}'s kernels in the SASS: {dict(per_cell)}")
        print(f"[0] {k} SASS: every s16x2 kernel runs {relu_ops[0]}; ALU instructions per cell of the inner loop, "
              f"L: s16x2 | int32: " + ", ".join(f"{l}: {per_cell['s16x2'][l]:.3f} | {per_cell['int32'][l]:.3f}"
                                                  for l in _LANES))
        regs = register_summary(_cuda.build_info["log"])[f"{name}_s16x2_kernel"]
        fail_unless(len(regs) == len(_LANES) and not any("s" in w.split(":")[-1] for w in regs),
                    f"{k}'s s16x2 kernel spills: {regs}")
    # K1's and K4's striped kernels (rows of more than 1,024 lanes, L =
    # kStripeL): the s16x2 ones run the DPX instruction and spill nothing;
    # the ALU instructions a cell of each one's inner loop (the stripe
    # step) beside the int32 striped kernel's.
    wide_cell = {}
    for fname, instrs in lib_sass.items():
        kernel = kernel_identifier(fname)
        if kernel in WIDE_KERNELS:
            fail_unless("s16x2" not in kernel or relu_ops[0] in {op for _, op, _ in instrs},
                        f"{kernel} lacks {relu_ops[0]}")
            wide_cell[kernel] = inner_loop_per_cell(instrs, 2 if "s16x2" in kernel else 1)
    wide_regs = {k: register_summary(_cuda.build_info["log"]).get(k, []) for k in WIDE_KERNELS}
    fail_unless(sorted(wide_cell) == sorted(WIDE_KERNELS)
                and all(len(wide_regs[k]) == 1 for k in WIDE_KERNELS)
                and not any("s" in wide_regs[k][0].split(":")[-1] for k in WIDE_KERNELS if "s16x2" in k),
                f"K1's and K4's striped kernels: {sorted(wide_cell)}, {wide_regs}")
    print(f"[0] K1 and K4 striped SASS: lane_best_wide_s16x2_kernel and score_grid_wide_s16x2_kernel run "
          f"{relu_ops[0]} and spill nothing; registers and ALU instructions per cell of the stripe step: "
          + ", ".join(f"{k} {wide_regs[k][0]} {wide_cell[k]:.3f}" for k in WIDE_KERNELS), flush=True)
    # K5's and K2's wide s16x2 kernels: the DPX instruction, no spill, and
    # the ALU instructions a cell of their inner loops (K5's row loop as
    # its one-pass kernel's below, with an eighth shuffle a row that hands
    # the row's last column to lane 0; K2's stripe step, two cells a
    # register).
    wide16 = {}
    for fname, instrs in lib_sass.items():
        kernel = kernel_identifier(fname)
        if kernel in WIDE16_ROW_ARGMAX:
            fail_unless(relu_ops[0] in {op for _, op, _ in instrs}, f"{kernel} lacks {relu_ops[0]}")
            loop = inner_loop_alu(instrs)
            wide16[kernel] = (len(loop) / (32 * sum(op.startswith("SHFL") for op in loop) / 8) if "row" in kernel
                              else len(loop) / (2 * max(1, sum(op.startswith("HSET2") for op in loop))))
    wide16_regs = {k: register_summary(_cuda.build_info["log"]).get(k, []) for k in WIDE16_ROW_ARGMAX}
    fail_unless(sorted(wide16) == sorted(WIDE16_ROW_ARGMAX)
                and all(len(w) == 1 and "s" not in w[0].split(":")[-1] for w in wide16_regs.values()),
                f"K5's and K2's wide s16x2 kernels: {sorted(wide16)}, {wide16_regs}")
    print(f"[0] K5 and K2 wide s16x2 SASS: score_row_wide_s16x2_kernel and argmax_wide_s16x2_kernel run "
          f"{relu_ops[0]} and spill nothing; registers and ALU instructions per cell of the inner loop: "
          + ", ".join(f"{k} {wide16_regs[k][0]} {wide16[k]:.3f}" for k in WIDE16_ROW_ARGMAX), flush=True)
    # The s16x2 kernels that share sweep_s16x2 (K1-K4's one-pass kernels,
    # K1's and K4's striped ones) or the row step (K5's one-pass kernel):
    # their SASS against the parent trees' (KEPT_SASS, built by the toolkit
    # it names), so the wide forms added beside them, and the pipelined
    # stripe step K2's striped kernel gave sweep_s16x2, are shown to leave
    # their code, and so their instructions per cell, as it was.
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[-1]
    kept = sass_digests(os.path.join(os.path.dirname(nvcc), "cuobjdump"), _cuda.build_info["path"],
                        r"(lane_best|argmax|band|score_grid|score_row|max_cells)_s16x2_kernel"
                        r"|(lane_best|score_grid|argmax|score_row)_wide_s16x2_kernel")
    if nvcc_version == KEPT_SASS["nvcc"]:
        fail_unless(kept == KEPT_SASS["kernels"],
                    f"the s16x2 kernels' SASS changed: {kept} against {KEPT_SASS['kernels']}")
        print(f"[0] s16x2 SASS unchanged from the parent trees ({nvcc_version}): "
              + ", ".join(f"{k} {n} functions {d}" for k, (n, d) in sorted(kept.items())), flush=True)
    else:
        print(f"[0] s16x2 SASS not compared: {nvcc_version}, the parents' digests are of "
              f"{KEPT_SASS['nvcc']}; now " + ", ".join(f"{k} {d}" for k, (_, d) in sorted(kept.items())),
              flush=True)
    # K5's s16x2 form, one kernel: its row loop holds a row of 16 registers
    # of two cells a thread, and each row takes seven shuffles (the NW
    # term, five scan steps, the value handed to the next lane).
    k5_sass = [instrs for fname, instrs in lib_sass.items() if re.search(r"\d+score_row_s16x2_kernel", fname)]
    fail_unless(len(k5_sass) == 1 and relu_ops[0] in {op for _, op, _ in k5_sass[0]},
                f"K5's s16x2 kernel ({len(k5_sass)} found) lacks {relu_ops[0]}")
    k5_regs = register_summary(_cuda.build_info["log"])["score_row_s16x2_kernel"]
    fail_unless(len(k5_regs) == 1 and "s" not in k5_regs[0], f"K5's s16x2 kernel spills: {k5_regs}")
    k5_loop = inner_loop_alu(k5_sass[0])
    k5_rows = sum(op.startswith("SHFL") for op in k5_loop) / 7
    print(f"[0] K5 SASS: score_row_s16x2_kernel runs {relu_ops[0]}, {k5_regs[0]} (no spill); its row loop: "
          f"{len(k5_loop)} ALU instructions over {k5_rows:g} row(s) of 32 cells a thread = "
          f"{len(k5_loop) / (32 * k5_rows):.3f} per cell", flush=True)
    # K8's three kernels and its finish: the s16x2 form runs the DPX
    # instruction of __viaddmax_s16x2_relu, and none of them spills.
    k8_sass = [instrs for fname, instrs in lib_sass.items() if re.search(r"\d+max_cells_s16x2_kernel", fname)]
    fail_unless(len(k8_sass) == 1 and relu_ops[0] in {op for _, op, _ in k8_sass[0]},
                f"K8's s16x2 kernel ({len(k8_sass)} found) lacks {relu_ops[0]}")
    k8_regs = {k: w for k, w in register_summary(_cuda.build_info["log"]).items() if k.startswith("max_cells")}
    fail_unless(sorted(k8_regs) == ["max_cells_finish_kernel", "max_cells_kernel", "max_cells_s16x2_kernel",
                                    "max_cells_wide_kernel", "max_cells_wide_s16x2_kernel"]
                and not any("s" in w for ws in k8_regs.values() for w in ws), f"K8's kernels: {k8_regs}")
    print(f"[0] K8 SASS: max_cells_s16x2_kernel runs {relu_ops[0]}; registers {k8_regs} (no spill)", flush=True)
    # K2's s16x2 kernel at every L runs the DPX instruction and spills
    # nothing, nor does its merge; the ALU instructions a cell of its inner
    # loop (two cells a register: the substitution's one f16 compare each).
    k2_cell = {}
    for fname, instrs in lib_sass.items():
        hit = re.search(r"\dargmax_s16x2_kernelILi(\d+)E", fname)
        if hit:
            fail_unless(relu_ops[0] in {op for _, op, _ in instrs}, f"K2's s16x2 kernel at L={hit.group(1)} lacks "
                                                                    f"{relu_ops[0]}")
            loop = inner_loop_alu(instrs)
            k2_cell[int(hit.group(1))] = len(loop) / (2 * max(1, sum(op.startswith("HSET2") for op in loop)))
    k2_regs = {k: w for k, w in register_summary(_cuda.build_info["log"]).items() if k.startswith("argmax")}
    fail_unless(sorted(k2_cell) == list(_LANES) and len(k2_regs.get("argmax_s16x2_kernel", [])) == len(_LANES)
                and not any("s" in w.split(":")[-1] for k in ("argmax_s16x2_kernel", "argmax_merge_kernel")
                            for w in k2_regs.get(k, ["-s"])), f"K2's s16x2 kernels: {sorted(k2_cell)}, {k2_regs}")
    print(f"[0] K2 SASS: every argmax_s16x2_kernel runs {relu_ops[0]}, it and argmax_merge_kernel spill nothing; "
          f"ALU instructions per cell of its inner loop, L: "
          + ", ".join(f"{l}: {k2_cell[l]:.3f}" for l in _LANES)
          + f"; the int32 kernels (as in earlier trees): {k2_regs.get('argmax_kernel')}, "
            f"{k2_regs.get('argmax_wide_kernel')}", flush=True)
    # K3's s16x2 kernel at every L runs the DPX instruction and spills
    # nothing.  Its diagonal loop holds two unrolled steps, the plain one
    # (K1's) and the edge one (the boundary columns' hooks, run only on
    # the first m and the last diagonals): its ALU instructions beside
    # K1's loop's, the difference being the edge step's.
    k3_loop, k1_loop = {}, {}
    for fname, instrs in lib_sass.items():
        hit = re.search(r"\d(band|lane_best)_s16x2_kernelILi(\d+)E", fname)
        if hit:
            fail_unless(relu_ops[0] in {op for _, op, _ in instrs}, f"{hit.group(1)}_s16x2_kernel at L={hit.group(2)} "
                                                                    f"lacks {relu_ops[0]}")
            (k3_loop if hit.group(1) == "band" else k1_loop)[int(hit.group(2))] = len(inner_loop_alu(instrs))
    k3_regs = {k: w for k, w in register_summary(_cuda.build_info["log"]).items() if k.startswith("band")}
    fail_unless(sorted(k3_loop) == list(_LANES) and len(k3_regs.get("band_s16x2_kernel", [])) == len(_LANES)
                and not any("s" in w.split(":")[-1] for w in k3_regs["band_s16x2_kernel"]),
                f"K3's s16x2 kernels: {sorted(k3_loop)}, {k3_regs}")
    print(f"[0] K3 SASS: every band_s16x2_kernel runs {relu_ops[0]} and spills nothing ({k3_regs['band_s16x2_kernel']}); "
          f"ALU instructions of its diagonal loop (a plain and an edge step) | K1's (a plain step), L: "
          + ", ".join(f"{l}: {k3_loop[l]} | {k1_loop[l]}" for l in _LANES)
          + f"; the int32 kernels: {k3_regs.get('band_kernel')}, {k3_regs.get('band_wide_kernel')}", flush=True)
    # K3's and K8's wide s16x2 kernels: the DPX instruction, no spill, and
    # the ALU instructions a cell of their loops (K3's stripe loop, a plain
    # and an edge step, two cells a register; K8's row loop, 32 cells a
    # thread a row, the listing's branch, which runs only on a row that
    # reaches a best, counted in it).
    wide38 = {}
    for fname, instrs in lib_sass.items():
        kernel = kernel_identifier(fname)
        if kernel in WIDE16_BAND_CELLS:
            fail_unless(relu_ops[0] in {op for _, op, _ in instrs}, f"{kernel} lacks {relu_ops[0]}")
            loop = inner_loop_alu(instrs)
            wide38[kernel] = (len(loop) / (2 * max(1, sum(op.startswith("HSET2") for op in loop))) if "band" in kernel
                              else len(loop) / 32)
    wide38_regs = {k: register_summary(_cuda.build_info["log"]).get(k, []) for k in WIDE16_BAND_CELLS}
    fail_unless(sorted(wide38) == sorted(WIDE16_BAND_CELLS)
                and all(len(w) == 1 and "s" not in w[0].split(":")[-1] for w in wide38_regs.values()),
                f"K3's and K8's wide s16x2 kernels: {sorted(wide38)}, {wide38_regs}")
    print(f"[0] K3 and K8 wide s16x2 SASS: band_wide_s16x2_kernel and max_cells_wide_s16x2_kernel run "
          f"{relu_ops[0]} and spill nothing; registers and ALU instructions per cell of the loop: "
          + ", ".join(f"{k} {wide38_regs[k][0]} {wide38[k]:.3f}" for k in WIDE16_BAND_CELLS), flush=True)
    # K9's two kernels (one per tie order) and K10's, and the kernels of
    # both in one launch (fill_walk_kernel: two tie orders x three tile
    # widths x two modes): none spills.
    k910_regs = {k: w for k, w in register_summary(_cuda.build_info["log"]).items()
                 if k in ("fill_dirs_kernel", "trace_walk_kernel", "fill_walk_kernel")}
    fail_unless([len(k910_regs.get(k, [])) for k in ("fill_dirs_kernel", "trace_walk_kernel", "fill_walk_kernel")]
                == [2, 1, 12]
                and not any("s" in w for ws in k910_regs.values() for w in ws), f"K9's and K10's kernels: {k910_regs}")
    print(f"[0] K9 and K10 ptxas: registers {k910_regs} (no spill)", flush=True)
    # K6's and K7's s16x2 kernels (every L, K6 masked or not, K7's variants
    # A, B, D, E): each runs the DPX instruction and spills nothing, and
    # K6's inner loop, the bench's yardstick for K4, takes no more ALU
    # instructions per cell than sweep_s16x2's (K4's) at the bench's L = 4.
    k67_cell = collections.defaultdict(dict)
    for fname, instrs in lib_sass.items():
        for k, pattern in (("K6", r"\dstep_chain_s16x2_kernelILi(\d+)ELb([01])E"),
                           ("K7", r"\dstep_variant_s16x2_kernelILi(\d+)ELi(\d+)E")):
            hit = re.search(pattern, fname)
            if hit:
                fail_unless(relu_ops[0] in {op for _, op, _ in instrs},
                            f"{k}'s s16x2 kernel {hit.group(1, 2)} lacks {relu_ops[0]}")
                k67_cell[k][int(hit.group(1)), int(hit.group(2))] = inner_loop_per_cell(instrs, 2)
    fail_unless(sorted(k67_cell["K6"]) == [(l, mk) for l in _LANES for mk in (0, 1)]
                and sorted(k67_cell["K7"]) == [(l, v) for l in (1, 2, 4, 8, 16, 32) for v in (0, 1, 3, 4)],
                f"K6's and K7's s16x2 kernels in the SASS: {sorted(k67_cell['K6'])}, {sorted(k67_cell['K7'])}")
    k67_regs = {k: w for k, w in register_summary(_cuda.build_info["log"]).items()
                if k in ("step_chain_s16x2_kernel", "step_variant_s16x2_kernel")}
    fail_unless(len(k67_regs.get("step_chain_s16x2_kernel", [])) == 2 * len(_LANES)
                and len(k67_regs.get("step_variant_s16x2_kernel", [])) == 4 * 6
                and not any("s" in w.split(":")[-1] for ws in k67_regs.values() for w in ws),
                f"K6's and K7's s16x2 kernels spill: {k67_regs}")
    fail_unless(k67_cell["K6"][4, 0] <= s16x2_cell["K4"][4],
                f"K6's s16x2 loop takes {k67_cell['K6'][4, 0]:.3f} ALU instructions a cell at L=4, "
                f"sweep_s16x2 (K4) {s16x2_cell['K4'][4]:.3f}: not a ceiling for K4")
    print(f"[0] K6 and K7 SASS: every s16x2 kernel runs {relu_ops[0]}, none spills; ALU instructions per cell of "
          f"the inner loop, L: K6 | K6 masked | K7 A | sweep_s16x2 (K4): " + ", ".join(
              f"{l}: {k67_cell['K6'][l, 0]:.3f} | {k67_cell['K6'][l, 1]:.3f} | "
              + (f"{k67_cell['K7'][l, 0]:.3f}" if (l, 0) in k67_cell["K7"] else "-")
              + f" | {s16x2_cell['K4'][l]:.3f}" for l in _LANES), flush=True)

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def traced(counts, leg):
        """Fails unless a leg that traced a winner filled and walked it
        through K9 and K10 in one launch (fill_list, fill_walk), and never
        through their separate launches (fill_dirs, trace_walk); the
        launches, for its line."""
        fail_unless(counts["fill_list"] + counts["fill_walk"] > 0 and counts["fill_dirs"] == counts["trace_walk"] == 0,
                    f"K9 and K10 did not trace {leg} in one launch: {counts}")
        return f"fill_list {counts['fill_list']}, fill_walk {counts['fill_walk']}"

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

    def k1(fn, args, params=PARAMS, **kw):
        packed, refs, lens, offsets = args
        return fn(packed, refs, lens, *params, offsets=offsets, **kw)

    def by_form(counts, fn):
        """(fn(), {form: launches fn made in that form}), counts a
        kernel's launches per form (cuda_score.K1_FORMS or K4_FORMS)."""
        before = dict(counts)
        out = fn()
        return out, {form: n - before[form] for form, n in counts.items()}

    def k1_err(args, start, params=PARAMS, form="s16x2"):
        """Max abs error of K1 against its plain version at every start
        lane, failing unless the wrapper took ``form`` by its rule."""
        k, forms = by_form(cuda_score.K1_FORMS, lambda: k1(cuda_score.lane_best_packed_varlen, args, params))
        fail_unless(forms[form] == 1, f"K1 took {forms} at m={args[0].shape[1]}, scheme {params}, not {form}")
        p = read_best(k1(cuda_score.lane_best_packed_varlen_plain, args, params), start)
        return int((read_best(k, start).to(torch.int64) - p).abs().max()) if p.numel() else 0

    def k1_int32_err(args, start, params=PARAMS):
        """The same for the int32 form on the same inputs."""
        k = read_best(k1(cuda_score._lane_best_packed_varlen, args, params, form="int32"), start)
        p = read_best(k1(cuda_score.lane_best_packed_varlen_plain, args, params), start)
        return int((k.to(torch.int64) - p).abs().max()) if p.numel() else 0

    def layout_rows(layouts, m):
        """K1's inputs for packed rows built by hand: row r holds segments
        of the lengths layouts[r] (random codes, the trailing pad lanes a
        segment of their own), with the flat index of every segment start."""
        packed = np.full((len(layouts), m), READ_PAD, np.int32)
        starts = []
        for r, segs in enumerate(layouts):
            o = 0
            for n in segs:
                packed[r, o : o + n] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
                packed[r, o] |= START_BIT
                starts.append(r * m + o)
                o += n
            if o < m:
                packed[r, o] |= START_BIT
        return up(packed), np.array(starts, np.int32)

    clock.done(0)

    # -- 1. K1 against its plain version -----------------------------------
    reads_1 = rand_seqs(rng, rng.integers(80, 151, size=512))
    refs_1 = rand_seqs(rng, rng.integers(500, 4000, size=256))
    args_1, start_1, _ = k1_args(reads_1, refs_1, 256)
    k1_max_err = max(k1_err(args_1, start_1), k1_int32_err(args_1, start_1))
    fail_unless(k1_max_err == 0, f"K1 differs from plain at start lanes (max abs err {k1_max_err})")
    torch.cuda.synchronize()
    t = time.perf_counter()
    k1(cuda_score.lane_best_packed_varlen_plain, args_1)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t) * 1e3
    cells_1 = sum(map(len, reads_1)) * sum(map(len, refs_1))
    k1_bytes = sum(t.numel() * t.element_size() for t in args_1) + len(refs_1) * args_1[0].numel() * 4
    k1_bound_ms, k1_bound_by = bound(cells_1, k1_bytes, sms, clock_mhz)
    k1_ab, _ = in_turns(lambda form: k1(cuda_score._lane_best_packed_varlen, args_1, form=form), 10)
    k1_ms, k1_int32_ms = (float(np.mean(k1_ab[form])) for form in ("s16x2", "int32"))
    print(f"[1] K1 512 reads x 256 refs (500-4000 bp, flat buffer), rows {tuple(args_1[0].shape)}: max abs err 0 in "
          f"both forms; in turns int32 {k1_ab['int32'][0]:.3f}, s16x2 {k1_ab['s16x2'][0]:.3f}, s16x2 "
          f"{k1_ab['s16x2'][1]:.3f}, int32 {k1_ab['int32'][1]:.3f} ms: s16x2 {k1_ms:.3f} ms "
          f"({cells_1 / k1_ms / 1e6:.1f} GCUPS real cells, {100 * k1_bound_ms / k1_ms:.1f}% of the bound), int32 "
          f"{k1_int32_ms:.3f} ms ({100 * k1_bound_ms / k1_int32_ms:.1f}%), {k1_int32_ms / k1_ms:.2f}x; plain "
          f"{k1_plain_ms:.1f} ms; bound {k1_bound_ms:.3f} ms by {k1_bound_by} ({cells_1:.3e} cells, {k1_bytes} bytes)",
          flush=True)
    fail_unless(k1_ms < k1_int32_ms, "K1's s16x2 form is not faster than its int32 form")

    reads_l = rand_seqs(rng, rng.integers(80, 151, size=64))
    refs_l = rand_seqs(rng, [LONG_N] * 8)
    args_l, start_l, _ = k1_args(reads_l, refs_l, 256)
    got_l, forms = by_form(cuda_score.K1_FORMS,
                           lambda: read_best(k1(cuda_score.lane_best_packed_varlen, args_l), start_l))
    fail_unless(forms["s16x2"] == 1, f"K1 at 131 kb refs took {forms}")
    refs_l_pad = up(encode_batch(refs_l, LONG_N, REF_PAD))
    torch.cuda.synchronize()
    t = time.perf_counter()
    want_l = torch.cat(
        [score_grid(up(encode_batch(reads_l, 152, READ_PAD)), refs_l_pad[c : c + 2], *PARAMS) for c in range(0, 8, 2)],
        dim=1,
    )
    torch.cuda.synchronize()
    kl_plain_ms = (time.perf_counter() - t) * 1e3  # the row-form recurrence: the same read bests
    err_l = int((got_l.to(torch.int64) - want_l).abs().max())
    fail_unless(err_l == 0, f"K1 at 131 kb refs differs from the row-form recurrence ({err_l})")
    kl_ms = cuda_ms(lambda: k1(cuda_score.lane_best_packed_varlen, args_l), 3)
    cells_l = sum(map(len, reads_l)) * 8 * LONG_N
    kl_bound_ms, kl_bound_by = bound(
        cells_l, sum(t.numel() * t.element_size() for t in args_l) + 8 * args_l[0].numel() * 4, sms, clock_mhz
    )
    print(f"[1] K1 (s16x2) 64 reads x 8 refs of {LONG_N} bp vs row-form recurrence: max abs err 0; "
          f"kernel {kl_ms:.3f} ms ({cells_l / kl_ms / 1e6:.1f} GCUPS real cells), the recurrence (plain) "
          f"{kl_plain_ms:.1f} ms; bound {kl_bound_ms:.3f} ms by {kl_bound_by} = {100 * kl_bound_ms / kl_ms:.1f}%",
          flush=True)

    edge_reads = ["", "A", "ACGT" * 10, ""] + rand_seqs(rng, rng.integers(1, 120, size=20))
    edge_refs = ["", "A", "C"] + rand_seqs(rng, [2, 700, 2049])
    for m_pack in (128, 512):
        for padded in (False, True):
            args, start, order = k1_args(edge_reads, edge_refs, m_pack, padded, row_multiple=32)
            fail_unless((args[0][-1] == 256).sum() == 1, "edge case lacks an all-pad row")
            err = max(k1_err(args, start), k1_int32_err(args, start))
            fail_unless(err == 0, f"K1 edge cases differ at m_pack={m_pack}, padded={padded} ({err})")
            cols = [k for k, c in enumerate(order) if len(edge_refs[c]) <= 2]
            want = np.array([[oracle.opt_alignments(edge_refs[order[k]], r)[0] for k in cols] for r in edge_reads[:8]])
            got = read_best(k1(cuda_score.lane_best_packed_varlen, args), start)[:8, cols].cpu().numpy()
            fail_unless((got == want).all(), f"K1 edge cases differ from the oracle at m_pack={m_pack}, padded={padded}")
    print("[1] K1 edge cases (empty reads, 0/1 bp refs, all-pad rows, m_pack 128 and 512, flat and padded refs): "
          "both forms equal to plain and oracle", flush=True)

    # The s16x2 form's own edges: an odd number of rows (the last pairs
    # with an all-pad row), paired rows with different segment layouts,
    # and the scheme at the edge of k1_form's rule.
    args, start, _ = k1_args(reads_1[:201], refs_1[:16], 256, row_multiple=1)
    if args[0].shape[0] % 2 == 0:  # drop the last row and its reads
        keep = start < (args[0].shape[0] - 1) * 256
        args, start = (args[0][:-1], *args[1:]), start[keep]
    fail_unless(args[0].shape[0] % 2 == 1, "the odd-row case has an even number of rows")
    err_odd = k1_err(args, start)
    layouts = [[256], [16] * 16, [1] * 256, [100, 3, 150], [255], [7, 249], [128, 128], [64] * 3, [2, 250]]
    packed_p, start_p = layout_rows(layouts, 256)
    err_pairs = k1_err((packed_p, *args_1[1:]), start_p)
    read_b = rand_seqs(rng, [1024])[0]
    args_b, start_b, _ = k1_args([read_b], [read_b], 1024, row_multiple=1)
    boundary = {}
    for params, form in (((31, -3, -4), "s16x2"), ((32, -3, -4), "int32")):
        got, forms = by_form(cuda_score.K1_FORMS,
                             lambda: read_best(k1(cuda_score.lane_best_packed_varlen, args_b, params), start_b))
        fail_unless(forms[form] == 1, f"K1 at m=1024, scheme {params} took {forms}, not {form}")
        boundary[params[0]] = int(got[0, 0])
        fail_unless(boundary[params[0]] == 1024 * params[0] and k1_err(args_b, start_b, params, form) == 0,
                    f"K1 on a 1,024 bp read equal to its ref at match {params[0]}: {boundary[params[0]]}")
    args_g = k1_args(reads_1[:64], refs_1[:32], 256)[:2]
    err_gap = max(k1_err(*args_g, params) for params in ((5, -3, -32768), (5, -32768, -32768)))
    err_s16 = max(err_odd, err_pairs, err_gap)
    fail_unless(err_s16 == 0, f"K1's s16x2 form differs from plain (odd rows {err_odd}, paired layouts {err_pairs}, "
                              f"gap -32768 {err_gap})")
    k1_max_err = max(k1_max_err, err_s16)
    print(f"[1] K1 s16x2: {args[0].shape[0]} rows (odd), {len(layouts)} hand-packed rows of different segment layouts "
          f"(1-256 lanes) in pairs, gap -32768 (and mismatch -32768) equal to plain at every start lane; a 1,024 bp "
          f"read equal to its ref scores {boundary[31]} at match 31 (s16x2) and {boundary[32]} at match 32 (int32), "
          f"equal to plain", flush=True)

    clock.done(1)

    # -- 2. K2 against its plain version -----------------------------------
    def consumed_err(k, p, what):
        """Max abs error of K2's outputs ``k`` against ``p`` on the lanes
        the traceback reads (best = the read's max), failing unless those
        lanes are the same."""
        consumed = p[0] == p[0].amax(dim=2, keepdim=True)
        fail_unless(torch.equal(k[0] == k[0].amax(dim=2, keepdim=True), consumed), f"K2 max lanes differ ({what})")
        return max(int((a.to(torch.int64) - b)[consumed].abs().max()) for a, b in zip(k, p))

    def k2_grid(reads, ref):
        m_pad = max(8, -(-max(map(len, reads)) // 8) * 8)
        return up(encode_batch(reads, m_pad, READ_PAD)), up(encode_batch([ref], len(ref), REF_PAD))

    def k2_forms_err(args, want, what):
        """Max abs error on the consumed lanes of K2 against ``want`` in its
        s16x2 form (in column segments where its plan splits), the s16x2
        form as one segment and the int32 form, each checked to take its
        form."""
        err = 0
        for kw in ({}, {"split": False}, {"form": "int32"}):
            form = kw.get("form", "s16x2")
            before = dict(cuda_score.K2_FORMS)
            k = cuda_score._argmax_lane(*args, *PARAMS, **kw)
            fail_unless(cuda_score.K2_FORMS[form] == before[form] + 1, f"K2 took {cuda_score.K2_FORMS}, not {form}")
            err = max(err, consumed_err(k, want, f"{what}, {form} {kw}"))
        return err

    def k2_bound(args):
        """K2's bound: the reads' real cells x the ref, its inputs and three
        outputs of 4 bytes a lane."""
        real = int((args[0] != READ_PAD).sum())
        return bound(real * args[1].shape[1], sum(t.numel() * t.element_size() for t in args) + 12 * args[0].numel(),
                     sms, clock_mhz)

    reads_2 = rand_seqs(rng, rng.integers(80, 151, size=2000))
    ref_2 = rand_seqs(rng, [2000])[0]
    args_2 = k2_grid(reads_2, ref_2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want_2 = cuda_score.argmax_lane_plain(*args_2, *PARAMS)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t) * 1e3
    k2_max_err = k2_forms_err(args_2, want_2, "2 kb")
    fail_unless(k2_max_err == 0, f"K2 differs from plain on consumed lanes ({k2_max_err})")
    k2_ab, _ = in_turns(lambda form: cuda_score._argmax_lane(*args_2, *PARAMS, form=form), 10)
    k2_ms, k2_int32_ms = (float(np.mean(k2_ab[form])) for form in ("s16x2", "int32"))
    k2_bound_ms, k2_bound_by = k2_bound(args_2)
    print(f"[2] K2 2000 reads x 2 kb ref: max abs err 0 in both forms and as one segment; in turns int32 "
          f"{k2_ab['int32'][0]:.3f}, s16x2 {k2_ab['s16x2'][0]:.3f}, s16x2 {k2_ab['s16x2'][1]:.3f}, int32 "
          f"{k2_ab['int32'][1]:.3f} ms ({k2_int32_ms / k2_ms:.2f}x), plain {k2_plain_ms:.1f} ms; bound "
          f"{k2_bound_ms:.3f} ms by {k2_bound_by} = {100 * k2_bound_ms / k2_ms:.1f}% of the s16x2 form's time",
          flush=True)
    # Ties planted at the segment borders K2's plan makes of a 131 kb ref
    # for two 16 bp reads (A, C and G only) in a ref of Ts: copies whose
    # last cell (lane 15, diagonal end + 15) lies on either side of a
    # segment's first owned diagonal and inside a segment's first W - 1
    # columns (owned by the segment before).  Each copy is a cell at the
    # best 80: counted once, the first copy's diagonal kept.
    rng_k2 = np.random.default_rng(SEED + 2)
    reads_k2b = ["".join(rng_k2.choice(list("ACG"), size=16)) for _ in range(2)]
    st_b, _, off_b, cnt_b = cuda_score.argmax_segments(16, LONG_N, *PARAMS, 1, sms)
    first_d = [s * st_b + off_b for s in range(cnt_b)]  # global diagonal segment s >= 1 owns from
    ends_k2b = [[first_d[30] - 16, first_d[70] - 15, 110 * st_b + 20], [first_d[150] - 14, 200 * st_b + 30]]
    ref_k2b = bytearray(b"T" * LONG_N)
    for read, ends in zip(reads_k2b, ends_k2b):
        for end in ends:
            ref_k2b[end - 15 : end + 1] = read.encode()
    args_k2b = k2_grid(reads_k2b, ref_k2b.decode())
    # The plain version of both: one diagonal loop over the two refs (its
    # cost is per diagonal), sliced to each case's reads, ref and lanes.
    args_2l = k2_grid(reads_l, refs_l[0])
    plain_2 = cuda_score.argmax_lane_plain(
        up(encode_batch(reads_l + reads_k2b, args_2l[0].shape[1], READ_PAD)),
        up(encode_batch([refs_l[0], ref_k2b.decode()], LONG_N, REF_PAD)), *PARAMS)
    want_2l = tuple(t[: len(reads_l), :1] for t in plain_2)
    want_k2b = tuple(t[len(reads_l) :, 1:, :16] for t in plain_2)
    err = k2_forms_err(args_2l, want_2l, "131 kb")
    fail_unless(err == 0, f"K2 at a 131 kb ref differs from plain ({err})")
    fail_unless(want_k2b[0][:, 0, 15].tolist() == [80, 80] and want_k2b[2][:, 0, 15].tolist() == [3, 2]
                and want_k2b[1][:, 0, 15].tolist() == [ends_k2b[0][0] + 15, ends_k2b[1][0] + 15],
                f"the plain version misses the planted ties: {[w[:, 0, 15].tolist() for w in want_k2b]}")
    err = k2_forms_err(args_k2b, want_k2b, "planted ties at the segment borders")
    fail_unless(err == 0 and cnt_b > 200, f"K2 differs on the ties planted at its segment borders ({err}, {cnt_b})")
    k2l_plan = cuda_score.argmax_segments(args_2l[0].shape[1], LONG_N, *PARAMS, -(-len(reads_l) // 8), sms)
    k2l_int32_ms = cuda_ms(lambda: cuda_score._argmax_lane(*args_2l, *PARAMS, form="int32"), 3)
    k2l_ms = cuda_ms(lambda: cuda_score.argmax_lane(*args_2l, *PARAMS), 3)
    k2l_unsplit_ms = cuda_ms(lambda: cuda_score._argmax_lane(*args_2l, *PARAMS, split=False), 3)
    k2l_bound_ms, k2l_bound_by = k2_bound(args_2l)
    fail_unless(k2l_plan[3] > 1 and k2l_unsplit_ms >= 5 * k2l_ms,
                f"K2's s16x2 form at 131 kb in {k2l_plan[3]} segments takes {k2l_ms:.3f} ms, "
                f"as one {k2l_unsplit_ms:.3f}")
    print(f"[2] K2 64 reads x {LONG_N} bp ref: max abs err 0 in the s16x2 form in {k2l_plan[3]} column segments "
          f"(stride {k2l_plan[0]}, offset {k2l_plan[2]}), as one segment and in int32; s16x2 {k2l_ms:.3f} ms in "
          f"segments, {k2l_unsplit_ms:.3f} as one, int32 {k2l_int32_ms:.3f}; bound {k2l_bound_ms:.3f} ms by "
          f"{k2l_bound_by} = {100 * k2l_bound_ms / k2l_ms:.1f}%", flush=True)
    # Small cases against plain: 1-19 reads (odd counts leave a warp's high
    # half empty) of every L's width, 1-3 refs of 1-3,000 bp (segments
    # where the plan splits them), schemes with mismatch or gap 0 (one
    # segment; the padding diagonals masked).
    rng_k2s = np.random.default_rng(SEED + 22)
    for case in range(24):
        m_s = int(rng_k2s.choice([8, 24, 40, 100, 152, 200, 320, 500, 1000, 1024]))
        params_s = [PARAMS, (5, 0, -4), (5, -3, 0), (5, 0, 0), (2, -1, -1), (31, -3, -4)][case % 6]
        reads_s = rand_seqs(rng_k2s, rng_k2s.integers(1, m_s + 1, int(rng_k2s.integers(1, 20))))
        refs_s = rand_seqs(rng_k2s, rng_k2s.integers(1, 3001, int(rng_k2s.integers(1, 4))))
        args_s = (up(encode_batch(reads_s, m_s, READ_PAD)), up(encode_batch(refs_s, max(map(len, refs_s)), REF_PAD)))
        want_s = cuda_score.argmax_lane_plain(*args_s, *params_s)
        for kw in ({}, {"split": False}):
            got_s = cuda_score._argmax_lane(*args_s, *params_s, form="s16x2", **kw)
            cons_s = want_s[0] == want_s[0].amax(dim=2, keepdim=True)
            fail_unless(all(torch.equal(g[cons_s], w[cons_s]) for g, w in zip(got_s, want_s))
                        and torch.equal(got_s[0] == got_s[0].amax(dim=2, keepdim=True), cons_s),
                        f"K2's s16x2 form differs from plain: {len(reads_s)} reads of width {m_s} x refs of "
                        f"{list(map(len, refs_s))} bp, scheme {params_s}, {kw}")
    print("[2] K2's s16x2 form equal to plain in 24 small cases (1-19 reads of width 8-1,024, 1-3 refs of 1-3,000 "
          "bp, mismatch and gap 0, match x width up to 31,744), in segments and as one", flush=True)
    # The long-ref workload's winner: 256 reads x a 0.95 Mb ref, held to the
    # int32 form as one segment (itself held to plain at 131 kb above).
    reads_2x = rand_seqs(rng_k2, rng_k2.integers(80, 151, size=256))
    args_2x = k2_grid(reads_2x, rand_seqs(rng_k2, [950_000])[0])
    want_2x = cuda_score._argmax_lane(*args_2x, *PARAMS, form="int32")
    err = consumed_err(cuda_score.argmax_lane(*args_2x, *PARAMS), want_2x, "0.95 Mb")
    fail_unless(err == 0, f"K2's s16x2 form at 0.95 Mb differs from its int32 form ({err})")
    k2x_ab, _ = in_turns(lambda form: cuda_score._argmax_lane(*args_2x, *PARAMS, form=form), 2)
    k2x_ms, k2x_int32_ms = (float(np.mean(k2x_ab[form])) for form in ("s16x2", "int32"))
    k2x_bound_ms, _ = k2_bound(args_2x)
    print(f"[2] K2 ties planted at {len(ends_k2b[0]) + len(ends_k2b[1])} places around the borders of {cnt_b} "
          f"segments of a {LONG_N} bp ref (stride {st_b}, offset {off_b}): equal to plain in both forms and as one "
          f"segment; 256 reads x 0.95 Mb: the s16x2 form equal to int32, in turns s16x2 {k2x_ms:.3f} ms, "
          f"int32 {k2x_int32_ms:.3f} ms ({k2x_int32_ms / k2x_ms:.2f}x); bound {k2x_bound_ms:.3f} ms", flush=True)

    # -- 2. K8 against its plain version, on the reads K2 finds tied --------
    def tied(args, reads):
        """The rows of K2's reads that it finds tied inside a DP row, as
        find_max_cells_batched picks them: (reads, bests, real bp)."""
        best, _, count = (t[:, 0] for t in cuda_score.argmax_lane(*args, *PARAMS))
        b = best.amax(dim=1)
        idx = np.flatnonzero((((best == b[:, None]) & (count != 1)).any(dim=1) & (b > 0)).cpu().numpy())
        fail_unless(idx.size > 0, "K2 finds no tied read")
        idx_t = up(idx)
        return args[0][idx_t].contiguous(), b[idx_t].to(torch.int32).contiguous(), sum(len(reads[k]) for k in idx)

    def k8_plain(reads, ref, best, capacity):
        """The plain listing, in groups of reads whose (R, M, N) stack of H
        holds at most 2^27 entries."""
        group = max(1, (1 << 27) // (reads.shape[1] * ref.shape[0]))
        outs = [cuda_score.max_cells_row_plain(reads[k : k + group], ref, best[k : k + group], *PARAMS, capacity)
                for k in range(0, reads.shape[0], group)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def k8_check(what, reads, ref, best, capacity, want=None, **kw):
        """K8 against the plain listing ``want`` at this capacity (computed
        when None), in the form the rule or ``form=`` picks: every count
        equal; the cells equal where the count fits the capacity, else the
        slots distinct cells of the full listing in row-major order.
        Returns (want, reads past the capacity)."""
        form = kw.get("form") or cuda_score.k5_form(reads.shape[1], *PARAMS)
        before = dict(cuda_score.K8_FORMS)
        count, cells = cuda_score._max_cells_row(reads, ref, best, *PARAMS, capacity, **kw)
        fail_unless(cuda_score.K8_FORMS[form] == before[form] + 1, f"K8 took {cuda_score.K8_FORMS}, not {form} ({what})")
        want = k8_plain(reads, ref, best, capacity) if want is None else want
        fail_unless(torch.equal(count, want[0]), f"K8 counts differ from plain ({what})")
        fits = want[0] <= capacity
        fail_unless(torch.equal(cells[fits], want[1][fits]), f"K8 cells differ from plain ({what})")
        over = (~fits).nonzero()[:, 0]
        if len(over):
            full = k8_plain(reads[over], ref, best[over], int(want[0].max()))[1].cpu().numpy()
            n = ref.shape[0]
            for k, r in enumerate(over.tolist()):
                key = cells[r].cpu().numpy().astype(np.int64) @ np.array([n, 1])
                fail_unless((np.diff(key) > 0).all() and np.isin(key, full[k] @ np.array([n, 1])).all(),
                            f"K8's slots past the capacity are not distinct cells of the listing ({what})")
        return want, len(over)

    reads_8, best_8, bp_8 = tied(args_2, reads_2)
    ref_8 = args_2[1][0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    want_8 = k8_plain(reads_8, ref_8, best_8, 1024)
    torch.cuda.synchronize()
    k8_plain_ms = (time.perf_counter() - t) * 1e3
    k8_check("2 kb", reads_8, ref_8, best_8, 1024, want_8)
    k8_check("2 kb, one segment", reads_8, ref_8, best_8, 1024, want_8, split=False)
    k8_check("2 kb, int32", reads_8, ref_8, best_8, 1024, want_8, form="int32")
    _, k8_over = k8_check("2 kb, capacity 2", reads_8, ref_8, best_8, 2)
    fail_unless(k8_over > 0, "no tied read has more than 2 cells at its best")
    k8_ms = cuda_ms(lambda: cuda_score.max_cells_row(reads_8, ref_8, best_8, *PARAMS, 1024), 10)
    k8_int32_ms = cuda_ms(lambda: cuda_score._max_cells_row(reads_8, ref_8, best_8, *PARAMS, 1024, form="int32"), 10)
    k8_plan = cuda_score.max_cells_segments(reads_8.shape[1], ref_8.numel(), *PARAMS, -(-len(best_8) // 8), sms)
    # The listing's kernel and its finish alone, the medians of 10 calls of
    # the wrapper, each launch timed by events around its C entry (the
    # wrapper's time above also holds the count's zeroing and the host's
    # launches).
    with entry_events(_cuda.lib(), ("swt_max_cells_row_s16x2", "swt_max_cells_finish")) as log:
        for _ in range(10):
            cuda_score.max_cells_row(reads_8, ref_8, best_8, *PARAMS, 1024)
        torch.cuda.synchronize()
    k8_device = collections.defaultdict(list)
    for name, start, end in log:
        k8_device[name].append(start.elapsed_time(end))
    fail_unless([len(k8_device[k]) for k in ("swt_max_cells_row_s16x2", "swt_max_cells_finish")] == [10, 10],
                f"10 calls of K8's wrapper made { {k: len(v) for k, v in k8_device.items()} } launches")
    k8_kernel_ms = float(np.median(k8_device["swt_max_cells_row_s16x2"]))
    k8_finish_ms = float(np.median(k8_device["swt_max_cells_finish"]))
    # The finish against its plain version: each read's cells of the plain
    # listing shuffled into its slots (-1 past them), and at a capacity past
    # the finish's shared memory (4,500 random cells of a 150 x 131,072 plane
    # a read) with a read of best 0 and one of best -1.
    rng_f = np.random.default_rng(SEED + 14)

    def finish_case(listings, best, m, n, capacity):
        count = torch.tensor([len(c) for c in listings], dtype=torch.int64)
        slots = torch.full((len(listings), capacity, 2), -1, dtype=torch.int32)
        for r, c in enumerate(listings):
            slots[r, : min(len(c), capacity)] = torch.from_numpy(rng_f.permutation(c)[:capacity].astype(np.int32))
        want = cuda_score.max_cells_finish_plain(count.to(dev), slots.to(dev), best, m, n)
        got = cuda_score.max_cells_finish(count.to(dev), slots.to(dev), best, m, n)
        fail_unless(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"K8's finish differs from plain (capacity {capacity})")

    finish_case([want_8[1][r, : int(want_8[0][r])].cpu().numpy() for r in range(len(best_8))], best_8,
                reads_8.shape[1], ref_8.numel(), 1024)
    big = [np.stack(np.divmod(rng_f.choice(150 * LONG_N, 4500, replace=False), LONG_N), 1) for _ in range(4)]
    finish_case(big, up(np.array([80, 5, 0, -1], np.int32)), 150, LONG_N, 5000)

    def k8_bytes(reads, ref, want):
        """Reads, ref and bests in; counts and the listed cells out."""
        return reads.numel() + ref.numel() + 12 * len(want[0]) + 8 * int(want[0].clamp(max=want[1].shape[1]).sum())

    k8_bound_ms, k8_bound_by = bound(bp_8 * ref_8.numel(), k8_bytes(reads_8, ref_8, want_8), sms, clock_mhz)
    print(f"[2] K8 {len(best_8)} of the 2000 reads tied (K2) x 2 kb ref, {int(want_8[0].sum())} cells at their "
          f"bests (up to {int(want_8[0].max())} a read): counts and cells equal plain in both forms, and at capacity "
          f"2 ({k8_over} reads past it) the counts and distinct cells of the listing; in {k8_plan} segments "
          f"(stride, length, skip) and as one; the finish equal to its plain version at capacity 1,024 and 5,000; "
          f"s16x2 {k8_ms:.3f} ms (of it the listing kernel {k8_kernel_ms:.4f} ms and the finish {k8_finish_ms:.4f} "
          f"ms, events), int32 {k8_int32_ms:.3f} ms, plain {k8_plain_ms:.1f} ms; bound {k8_bound_ms:.3f} ms by "
          f"{k8_bound_by} = {100 * k8_bound_ms / k8_ms:.1f}% of the wrapper's time", flush=True)
    reads_8l, best_8l, bp_8l = tied(args_2l, reads_l)
    ref_8l = args_2l[1][0]
    want_8l = k8_plain(reads_8l, ref_8l, best_8l, 1024)
    k8_check("131 kb, segments", reads_8l, ref_8l, best_8l, 1024, want_8l)
    k8_check("131 kb, one segment", reads_8l, ref_8l, best_8l, 1024, want_8l, split=False)
    k8_check("131 kb, int32", reads_8l, ref_8l, best_8l, 1024, want_8l, form="int32")
    k8l_ms = cuda_ms(lambda: cuda_score.max_cells_row(reads_8l, ref_8l, best_8l, *PARAMS, 1024), 3)
    k8l_unsplit_ms = cuda_ms(lambda: cuda_score._max_cells_row(reads_8l, ref_8l, best_8l, *PARAMS, 1024, split=False), 3)
    k8_stride = cuda_score.max_cells_segments(reads_8l.shape[1], LONG_N, *PARAMS, -(-len(best_8l) // 8), sms)[0]
    k8_segments = -(-LONG_N // k8_stride)
    k8l_bound_ms, k8l_bound_by = bound(bp_8l * LONG_N, k8_bytes(reads_8l, ref_8l, want_8l), sms, clock_mhz)
    print(f"[2] K8 {len(best_8l)} of the 64 reads tied (K2) x {LONG_N} bp ref, {int(want_8l[0].sum())} cells at "
          f"their bests: counts and cells equal plain in {k8_segments} column segments, as one segment and in the "
          f"int32 form; s16x2 {k8l_ms:.3f} ms in segments, {k8l_unsplit_ms:.3f} ms as one; bound {k8l_bound_ms:.3f} "
          f"ms by {k8l_bound_by} = {100 * k8l_bound_ms / k8l_ms:.1f}%", flush=True)

    # Ties planted at the split K8 makes of a 131 kb ref for two 16 bp
    # reads (one block): copies of each read (A, C and G only) in a ref of
    # Ts, ending on either side of segment borders, inside a segment's
    # first W - 1 columns (which the segment before lists) and on the first
    # column a segment lists itself.  Each copy is a cell at the best, in
    # both forms, listed once.
    rng_b = np.random.default_rng(SEED + 8)
    reads_b = ["".join(rng_b.choice(list("ACG"), size=16)) for _ in range(2)]
    w_b = 16 + PARAMS[0] * 16 // -PARAMS[2]
    stride_b, length_b, skip_b = cuda_score.max_cells_segments(16, LONG_N, *PARAMS, 1, sms)
    fail_unless(stride_b < LONG_N and skip_b == w_b - 1 and length_b >= stride_b + skip_b,
                f"K8 does not split 2 reads x {LONG_N} bp: {(stride_b, length_b, skip_b)}")
    ends_b = [[stride_b + 5, 2 * stride_b + skip_b - 1, 3 * stride_b + skip_b, 4 * stride_b - 1, 5 * stride_b + 15],
              [6 * stride_b, 7 * stride_b + skip_b // 2]]
    ref_b = bytearray(b"T" * LONG_N)
    for read, ends in zip(reads_b, ends_b):
        for end in ends:
            ref_b[end - 15 : end + 1] = read.encode()
    args_b = (up(encode_batch(reads_b, 16, READ_PAD)), up(encode_batch([ref_b.decode()], LONG_N, REF_PAD)[0]))
    best_b = up(np.full(2, 80, np.int32))
    want_b, _ = k8_check("planted ties at the segment borders", *args_b, best_b, 64)
    fail_unless(want_b[0].tolist() == [5, 2] and want_b[1][0, :5, 1].tolist() == ends_b[0],
                f"the planted ties are not the plain listing's: {want_b[0].tolist()}")
    k8_check("planted ties at the segment borders, int32", *args_b, best_b, 64, want_b, form="int32")

    # A read with more ties than the CPU's cap: on the card the traceback
    # lists them all on the device, and the host scan never runs.
    many = ["A" * 150, reads_l[0]]
    many_ref = "A" * LONG_N
    want_many = longseq._max_cells_host(encode_batch(many[:1], 150, READ_PAD)[0],
                                        encode_batch([many_ref], LONG_N, REF_PAD)[0], *PARAMS)
    host_scan = longseq._max_cells_host

    def no_host_scan(*_):
        raise RuntimeError("chip_smoke: the host scan ran on the card")

    longseq._max_cells_host = no_host_scan
    try:
        got_many = find_max_cells_batched(many, many_ref, PARAMS, device=dev)
    finally:
        longseq._max_cells_host = host_scan
    fail_unless(got_many[0][0] == want_many[0] and np.array_equal(got_many[0][1], want_many[1])
                and len(want_many[1]) > longseq._CAPACITY_CAP,
                f"find_max_cells_batched of a read with {len(want_many[1])} ties differs from the host scan")
    print(f"[2] K8 at the split of 2 reads x {LONG_N} bp ({-(-LONG_N // stride_b)} segments of stride {stride_b}, "
          f"W - 1 = {skip_b}): {want_b[0].tolist()} ties planted around segment borders listed once each, equal to "
          f"plain in both forms; find_max_cells_batched of a read with {len(want_many[1])} ties (past the CPU's cap of "
          f"{longseq._CAPACITY_CAP}) on the card equal to the host scan, which did not run", flush=True)

    # -- 2. K9 (fill with codes) and K10 (walk) against their plain versions --
    rng_9 = np.random.default_rng(SEED + 9)  # leaves the later phases' inputs as they were

    def window_jobs(ref, lens):
        """Inputs of one windowed dispatch as longseq builds them: each read
        a copy of the ref (about one base in 20 changed) ending at a random
        column, its window of window_width columns ending there, REF_PAD on
        the left to a multiple of 256; cells (K = 3): the read's last row in
        the last column (the max cell the main path walks from), a random
        cell of the plane, and none (-1).  Returns (reads, windows, cells, cap)."""
        m = int(max(lens))
        w = longseq.window_width(m, len(ref), *PARAMS)
        w_pad = max(256, -(-w // 256) * 256)
        table = np.frombuffer(b"ACGT", np.uint8)
        reads, windows = [], np.full((len(lens), w_pad), REF_PAD, np.uint8)
        for t, n in enumerate(lens):
            end = int(rng_9.integers(n, len(ref) + 1))
            read = np.frombuffer(ref[end - n : end].encode(), np.uint8).copy()
            hit = rng_9.random(n) < 1 / 20
            read[hit] = table[rng_9.integers(0, 4, int(hit.sum()))]
            reads.append(read.tobytes().decode())
            piece = ref[max(0, end - w) : end]
            windows[t, w_pad - len(piece) :] = encode_batch([piece], len(piece), REF_PAD)[0]
        cells = np.full((len(lens), 3, 2), -1, np.int32)
        cells[:, 0] = np.stack([np.asarray(lens) - 1, np.full(len(lens), w_pad - 1)], 1)
        cells[:, 1] = np.stack([rng_9.integers(0, m, len(lens)), rng_9.integers(0, w_pad, len(lens))], 1)
        return up(encode_batch(reads, m, READ_PAD)), up(windows), up(cells), m + w_pad

    def fill_walk_check(what, reads, refs, cells, cap, want_h):
        """K9 (codes, and H where want_h) and K10 exact against their plain
        versions in both tie orders; the plain walk's steps."""
        for tie in ("serial", "distributed"):
            h, dirs = cuda_score.fill_dirs(reads, refs, *PARAMS, tie_semantics=tie, want_h=want_h)
            plain_h, want_d = cuda_score.fill_dirs_plain(reads, refs, *PARAMS, tie_semantics=tie, want_h=want_h)
            fail_unless(torch.equal(dirs, want_d) and (not want_h or torch.equal(h, plain_h)),
                        f"K9 differs from plain ({what}, {tie})")
            got, want = cuda_score.trace_walk(dirs, cells, cap), cuda_score.trace_walk_plain(want_d, cells, cap)
            fail_unless(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                        f"K10 differs from plain ({what}, {tie})")
        return int((want[1] != 0).sum())

    def host_timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def k9_bytes(reads, refs, want_h):
        """Reads and refs in; the codes, and H where asked, out."""
        cells = reads.shape[0] * reads.shape[1] * refs.shape[1]
        return reads.numel() + refs.numel() + cells * (5 if want_h else 1), cells

    def k10_bytes(cells, cap, steps):
        """Cells in and a byte of codes per step read; begins and the codes out."""
        return cells.numel() * 4 + steps + cells.shape[0] * cells.shape[1] * (4 + cap)

    ref_9 = rand_seqs(rng_9, [2000])[0]
    win_9 = window_jobs(ref_9, rng_9.integers(80, 151, 64))
    steps_9 = fill_walk_check("64 windows of 80-150 bp x 512", *win_9, False)
    fail_unless(win_9[1].shape[1] == 512, f"the 150 bp windows are {win_9[1].shape[1]} columns, not 512")
    main_cells_9 = win_9[2][:, :1].contiguous()  # the main path walks one cell a job
    _, dirs_9 = cuda_score.fill_dirs(*win_9[:2], *PARAMS, tie_semantics="serial", want_h=False)
    steps_10 = int((cuda_score.trace_walk_plain(dirs_9, main_cells_9, win_9[3])[1] != 0).sum())
    k9_ms = cuda_ms(lambda: cuda_score.fill_dirs(*win_9[:2], *PARAMS, tie_semantics="serial", want_h=False), 10)
    k9_plain_ms = host_timed(lambda: cuda_score.fill_dirs_plain(*win_9[:2], *PARAMS, tie_semantics="serial",
                                                                 want_h=False))
    k10_ms = cuda_ms(lambda: cuda_score.trace_walk(dirs_9, main_cells_9, win_9[3]), 10)
    k10_plain_ms = host_timed(lambda: cuda_score.trace_walk_plain(dirs_9, main_cells_9, win_9[3]))
    k9_nbytes, k9_cells = k9_bytes(*win_9[:2], False)
    k9_bound_ms, k9_bound_by = bound(k9_cells, k9_nbytes, sms, clock_mhz)
    k10_bound_ms, k10_bound_by = bound(0, k10_bytes(main_cells_9, win_9[3], steps_10), sms, clock_mhz)
    print(f"[2] K9 and K10, 64 windows of 80-150 bp x 512 columns (3 cells a job, one of them -1; {steps_9} "
          f"steps): codes and walks equal plain in both tie orders; K9 (codes only) {k9_ms:.3f} ms, plain "
          f"{k9_plain_ms:.1f} ms, bound {k9_bound_ms:.4f} ms by {k9_bound_by} = {100 * k9_bound_ms / k9_ms:.1f}%; "
          f"K10 (one cell a job, {steps_10} steps) {k10_ms:.3f} ms, plain {k10_plain_ms:.1f} ms, bound "
          f"{k10_bound_ms:.5f} ms by {k10_bound_by} = {100 * k10_bound_ms / k10_ms:.1f}%", flush=True)

    # The full-fill branch: a chunk of reads x one 2 kb ref broadcast, H too,
    # the walks from argwhere_rows' cells at the branch's capacity and cap.
    reads_f = args_2[0][: (1 << 26) // (152 * 2048)]
    ref_f = up(encode_batch([ref_2], 2048, REF_PAD))
    h_f, _ = cuda_score.fill_dirs(reads_f, ref_f, *PARAMS, tie_semantics="serial", want_h=True)
    cells_f = cuda_score.argwhere_rows(h_f == h_f.amax(dim=(1, 2))[:, None, None], 64)
    cap_f = path_cap(152, PARAMS[0], PARAMS[2])
    steps_f = fill_walk_check(f"{reads_f.shape[0]} reads x 2 kb, ref broadcast", reads_f, ref_f, cells_f, cap_f, True)
    k9f_ms = cuda_ms(lambda: cuda_score.fill_dirs(reads_f, ref_f, *PARAMS, tie_semantics="serial", want_h=True), 5)
    k9f_plain_ms = host_timed(lambda: cuda_score.fill_dirs_plain(reads_f, ref_f, *PARAMS, tie_semantics="serial",
                                                                  want_h=True))
    _, dirs_f = cuda_score.fill_dirs(reads_f, ref_f, *PARAMS, tie_semantics="serial", want_h=False)
    k10f_ms = cuda_ms(lambda: cuda_score.trace_walk(dirs_f, cells_f, cap_f), 5)
    k9f_nbytes, k9f_cells = k9_bytes(reads_f, ref_f, True)
    k9f_bound_ms, k9f_bound_by = bound(k9f_cells, k9f_nbytes, sms, clock_mhz)
    k10f_bound_ms, _ = bound(0, k10_bytes(cells_f, cap_f, steps_f), sms, clock_mhz)
    del h_f

    # Windows of 1,025-2,048 bp reads (4 jobs of window_width(2,048) columns).
    win_l = window_jobs(rand_seqs(rng_9, [8000])[0], [1025, 1300, 1777, 2048])
    steps_l = fill_walk_check("4 windows of 1,025-2,048 bp", *win_l, False)
    k9l_ms = cuda_ms(lambda: cuda_score.fill_dirs(*win_l[:2], *PARAMS, tie_semantics="serial", want_h=False), 3)
    _, dirs_l = cuda_score.fill_dirs(*win_l[:2], *PARAMS, tie_semantics="serial", want_h=False)
    k10l_ms = cuda_ms(lambda: cuda_score.trace_walk(dirs_l, win_l[2], win_l[3]), 3)
    k9l_nbytes, k9l_cells = k9_bytes(*win_l[:2], False)
    k9l_bound_ms, _ = bound(k9l_cells, k9l_nbytes, sms, clock_mhz)
    k10l_bound_ms, _ = bound(0, k10_bytes(win_l[2], win_l[3], steps_l), sms, clock_mhz)
    print(f"[2] K9 and K10, {reads_f.shape[0]} reads x one 2 kb ref broadcast (H too; up to 64 cells a read from "
          f"argwhere_rows, cap {cap_f}): equal plain in both tie orders; K9 {k9f_ms:.3f} ms, plain {k9f_plain_ms:.1f} "
          f"ms, bound {k9f_bound_ms:.3f} ms by {k9f_bound_by} = {100 * k9f_bound_ms / k9f_ms:.1f}%; K10 {k10f_ms:.3f} "
          f"ms ({steps_f} steps), bound {k10f_bound_ms:.4f}. 4 windows of 1,025-2,048 bp x {win_l[1].shape[1]} "
          f"columns: equal plain in both tie orders; K9 {k9l_ms:.3f} ms (bound {k9l_bound_ms:.4f}), K10 "
          f"{k10l_ms:.3f} ms ({steps_l} steps, bound {k10l_bound_ms:.5f})", flush=True)

    # Reads past the full-fill branch's first listing (64 max cells): a 2 kb
    # ref of 100 copies of a 20 bp unit, so a 40 bp copy has 99 max cells and
    # a 2 bp read about 200; the branch lists and walks them again on the card.
    unit = "ACGTTGCAAGCTTCGAATGC"
    ref_t = unit * 100
    reads_t = [unit * 2, "GC", unit[3:17], "".join(rand_seqs(rng_9, [120]))]
    tie_backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir="."), dev)
    fail_unless(not tie_backend._windowed(ref_t, reads_t), "the many-tie reads do not take the full-fill branch")
    per_read_t = [tie_backend.sites_for_ref(ref_t, [r]) for r in reads_t]
    want_t = [sorted(oracle.opt_alignments(ref_t, r)[1], key=lambda site: site[0]) for r in reads_t]
    fail_unless(per_read_t == want_t, "the full-fill branch's sites of the many-tie reads differ from the oracle")
    fail_unless(min(map(len, per_read_t[:3])) > 64, f"a many-tie read has {min(map(len, per_read_t[:3]))} sites")
    print(f"[2] full-fill branch past its first 64 cells: reads with {[len(p) for p in per_read_t]} max cells x a "
          "2 kb tandem repeat, listed and walked again on the card, equal the oracle", flush=True)

    # -- 2. K9 and K10 in one launch against their plain versions: fill_walk
    # (the windowed branch) and fill_list (the full-fill branch) ----------
    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def device_ms(fns, iters, entries=("swt_fill_walk", "swt_fill_list")):
        """Device ms of each of fns' one launch of a C entry of
        ``entries``: the median over iters calls each, made in turns
        (fns[0], fns[1], ..., fns[0], ...) in one pass after 100 ms of
        such turns that warm the clocks (a round at a time, so that the
        host does not queue more rounds than the card runs in that time),
        so a change of the card's clock during the pass falls on every fn
        alike; each launch timed alone by events around its entry
        (:func:`entry_events`; the wrapper's event time also holds its
        allocations, its zeroing and the host's launch).  Fails unless
        every timed call made exactly one such launch."""
        t = time.perf_counter()
        while time.perf_counter() - t < 0.1:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        timed = [[] for _ in fns]
        with entry_events(_cuda.lib(), entries) as log:
            for _ in range(iters):
                for fn, ms in zip(fns, timed):
                    before = len(log)
                    fn()
                    fail_unless(len(log) == before + 1, f"a timed call launched {entries} {len(log) - before} times")
                    ms.append(log[-1])
                torch.cuda.synchronize()
        return [float(np.median([start.elapsed_time(end) for _, start, end in ms])) for ms in timed]

    def launch_turns(calls, same, iters):
        """({key: (wrapper ms by events, kernel ms by events around its
        launch)} of each of calls; the spread of ``same``'s).  The two keys
        of ``same`` make one launch (the public wrapper, and its route
        given): their kernels are timed in turns in one pass
        (:func:`device_ms`), and
        the script fails if their two medians differ (max / min - 1) by
        more than 5%."""
        kernel = dict(zip(same, device_ms([calls[key] for key in same], iters)))
        for key in calls:
            if key not in kernel:
                kernel[key] = device_ms([calls[key]], iters)[0]
        spread = max(kernel[key] for key in same) / min(kernel[key] for key in same) - 1
        fail_unless(spread <= 0.05, f"one launch read {[round(kernel[key], 4) for key in same]} ms by events "
                                    f"({same})")
        return {key: (cuda_ms(calls[key], iters), kernel[key]) for key in calls}, spread

    def walk_known(what, win, routes, iters):
        """fill_walk exact against its plain version (K9's and K10's) in
        both tie orders on each route, from the main path's cell (the
        read's last row in the window's last column), a random cell and
        none (-1, -1); then the main path's cell timed
        (:func:`launch_turns`): {route or "public" (the public wrapper, its
        route by fill_route): (wrapper ms, kernel ms)}, the plain version's
        ms, K9 then K10 as two launches (as _fill_walk_known ran them
        before) in ms, and the bound of the function: each window filled
        down to its cell's row, its inputs read and begins and codes
        written once."""
        reads, wins, cells3, cap = win
        for tie in ("serial", "distributed"):
            for c in range(cells3.shape[1]):
                cells = cells3[:, c].contiguous()
                want = cuda_score.fill_walk_plain(reads, wins, cells, *PARAMS, cap=cap, tie_semantics=tie)
                for route in routes:
                    got = cuda_score._fill_walk(reads, wins, cells, *PARAMS, cap=cap, tie_semantics=tie, route=route)
                    fail_unless(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                                f"fill_walk ({route}) differs from plain ({what}, cell {c}, {tie})")
        cells = cells3[:, 0].contiguous()
        calls = {"public": lambda: cuda_score.fill_walk(reads, wins, cells, *PARAMS, cap=cap, tie_semantics="serial")}
        for route in routes:
            calls[route] = functools.partial(cuda_score._fill_walk, reads, wins, cells, *PARAMS, cap=cap,
                                             tie_semantics="serial", route=route)
        times, spread = launch_turns(calls, ("public", cuda_score._fill_route_of(reads, wins, "serial")), iters)
        plain_ms = host_timed(lambda: cuda_score.fill_walk_plain(reads, wins, cells, *PARAMS, cap=cap,
                                                                 tie_semantics="serial"))

        def two_launches():
            _, dirs = cuda_score.fill_dirs(reads, wins, *PARAMS, tie_semantics="serial", want_h=False)
            return cuda_score.trace_walk(dirs, cells[:, None, :], cap)

        two_ms = cuda_ms(two_launches, iters)
        want = cuda_score.fill_walk_plain(reads, wins, cells, *PARAMS, cap=cap, tie_semantics="serial")
        dp = int((cells[:, 0].to(torch.int64) + 1).sum()) * wins.shape[1]
        return times, plain_ms, two_ms, bound(dp, nbytes(reads, wins, cells, *want), sms, clock_mhz), spread

    def fill_list_check(what, reads, ref, iters):
        """fill_list exact against its plain version (K9's with H,
        argwhere_rows, K10's) in every output, both tie orders, the
        reference broadcast and per pair, on both routes, at capacity 64
        and the branch's cap; the peak memory of one call (it must hold no
        (B, M, N) int32 H); then timed (:func:`launch_turns`): {route or
        "public" (the public wrapper, its route by fill_route): (wrapper
        ms, kernel ms)}, plain ms, fill_and_trace as it ran before (K9 with
        H, the torch listing, K10) in ms, and the bound: every cell of the
        planes, the inputs read and the five outputs written once."""
        b, m = reads.shape
        n = ref.shape[1]
        cap = path_cap(m, PARAMS[0], PARAMS[2])
        for tie in ("serial", "distributed"):
            for refs in (ref, ref.expand(b, -1).contiguous()):
                want = cuda_score.fill_list_plain(reads, refs, *PARAMS, capacity=64, cap=cap, tie_semantics=tie)
                for route in ("shared", "scratch"):
                    got = cuda_score._fill_list(reads, refs, *PARAMS, capacity=64, cap=cap, tie_semantics=tie,
                                                route=route)
                    fail_unless(all(torch.equal(g, w) for g, w in zip(got, want)),
                                f"fill_list ({route}) differs from plain ({what}, {tie}, refs {tuple(refs.shape)})")
        over, flat = int((want[1] > 64).sum()), int((want[0] == 0).sum())
        fail_unless(over > 0 and flat > 0, f"{what}: {over} pairs past capacity, {flat} of best 0")
        del want, got
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = cuda_score.fill_list(reads, ref, *PARAMS, capacity=64, cap=cap, tie_semantics="serial")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fail_unless(peak < b * m * n * 4, f"fill_list took {peak} bytes, an H of {b * m * n * 4}")
        calls = {"public": lambda: cuda_score.fill_list(reads, ref, *PARAMS, capacity=64, cap=cap,
                                                        tie_semantics="serial")}
        for route in ("shared", "scratch"):
            calls[route] = functools.partial(cuda_score._fill_list, reads, ref, *PARAMS, capacity=64, cap=cap,
                                             tie_semantics="serial", route=route)
        times, spread = launch_turns(calls, ("public", cuda_score._fill_route_of(reads, ref, "serial", 64)), iters)
        plain_ms = host_timed(lambda: cuda_score.fill_list_plain(reads, ref, *PARAMS, capacity=64, cap=cap,
                                                                 tie_semantics="serial"))

        def parent():
            h, dirs = cuda_score.fill_dirs(reads, ref, *PARAMS, tie_semantics="serial", want_h=True)
            eq = h == h.amax(dim=(1, 2))[:, None, None]
            eq.sum(dim=(1, 2), dtype=torch.int32)
            return cuda_score.trace_walk(dirs, cuda_score.argwhere_rows(eq, 64), cap)

        parent_ms = cuda_ms(parent, iters)
        return (times, plain_ms, parent_ms, bound(b * m * n, nbytes(reads, ref, *outs), sms, clock_mhz), peak, over,
                spread)

    fw = {"64": walk_known("64 windows of 80-150 bp x 512", win_9, ("shared", "scratch"), 20),
          "long": walk_known("4 windows of 1,025-2,048 bp", win_l, ("scratch",), 10)}
    for key, (times, plain_ms, two_ms, (b_ms, b_by), spread) in fw.items():
        print(f"[2] fill_walk, {key} windows: equal plain in both tie orders, routes "
              f"{sorted(k for k in times if k != 'public')}; wrapper/kernel ms: "
              + ", ".join(f"{k} {t[0]:.4f}/{t[1]:.4f}" for k, t in times.items())
              + f" (public and its route in turns, spread {100 * spread:.2f}%)"
              + f"; K9 then K10 {two_ms:.4f} ms; plain {plain_ms:.1f} ms; bound {b_ms:.5f} ms by {b_by}", flush=True)
    reads_fl = reads_f.clone()  # the full-fill chunk: "CA" (past capacity), "" (best 0), a copy of the ref
    reads_fl[:3] = up(encode_batch(["CA", "", ref_2[100:250]], reads_fl.shape[1], READ_PAD))
    ref_4 = rand_seqs(rng_9, [4096])[0]
    reads_4 = args_2[0][:512].clone()
    reads_4[:3] = up(encode_batch(["CA", "", ref_4[1000:1150]], reads_4.shape[1], READ_PAD))
    fl = {"2k": fill_list_check(f"{reads_fl.shape[0]} reads x 2 kb", reads_fl, ref_f, 20),
          "4k": fill_list_check("512 reads x 4 kb", reads_4, up(encode_batch([ref_4], 4096, REF_PAD)), 10)}
    for key, (times, plain_ms, parent_ms, (b_ms, b_by), peak, over, spread) in fl.items():
        print(f"[2] fill_list, {key}: every output equal plain in both tie orders, broadcast and per-pair refs, "
              f"both routes ({over} pairs past capacity 64); peak {peak / 1e6:.2f} MB; wrapper/kernel ms: "
              + ", ".join(f"{r} {t[0]:.4f}/{t[1]:.4f}" for r, t in times.items())
              + f" (public and its route in turns, spread {100 * spread:.2f}%)"
              + f"; K9 with H, the torch listing and K10 {parent_ms:.3f} ms; plain {plain_ms:.1f} ms; bound "
                f"{b_ms:.5f} ms by {b_by}", flush=True)

    # sites_for_pair_long, one read against a long reference: its best by
    # K5, its cells by K8, a window walked at each by fill_walk.
    t_pl = time.perf_counter()
    rng_pl = np.random.default_rng(SEED + 21)  # its own stream: the other inputs stay as they were
    read_pl = rand_seqs(rng_pl, [150])[0]
    pair_refs = {}
    for n_pl, at_pl in ((2_000, (120, 900, 1_700)), (LONG_N, (5_000, 64_000, 130_000))):
        ref_pl = list(rand_seqs(rng_pl, [n_pl])[0])
        for p in at_pl:
            ref_pl[p : p + 150] = read_pl
        pair_refs[n_pl] = "".join(ref_pl)
    before_pl = dict(cuda_score.LAUNCHES)
    got_pl = longseq.sites_for_pair_long(pair_refs[2_000], read_pl, PARAMS, device=dev)
    pl_launches = {k: cuda_score.LAUNCHES[k] - before_pl[k] for k in ("score_grid_row", "max_cells_row", "fill_walk")}
    fail_unless(all(pl_launches.values()), f"sites_for_pair_long did not launch K5, K8 and fill_walk: {pl_launches}")
    want_pl = oracle.opt_alignments(pair_refs[2_000], read_pl)[1]
    fail_unless(got_pl == want_pl and len(got_pl) == 3, f"sites_for_pair_long x 2 kb differs from the oracle "
                f"({len(got_pl)} sites against {len(want_pl)})")
    cells_pl = longseq.find_max_cells(read_pl, pair_refs[2_000], PARAMS, device=dev)
    fail_unless(longseq.sites_for_pair_long(pair_refs[2_000], read_pl, PARAMS, max_cells=cells_pl, device=dev)
                == want_pl, "sites_for_pair_long with max_cells= differs from the oracle")
    got_long_pl = longseq.sites_for_pair_long(pair_refs[LONG_N], read_pl, PARAMS, device=dev)
    want_long_pl = sites_for_ref_long_batched(
        pair_refs[LONG_N], [read_pl], PARAMS,
        cell_lists=find_max_cells_batched([read_pl], pair_refs[LONG_N], PARAMS, device=dev), device=dev,
    )[0]
    fail_unless(got_long_pl == want_long_pl and len(got_long_pl) == 3,
                f"sites_for_pair_long x {LONG_N} bp differs from sites_for_ref_long_batched")
    print(f"[2] sites_for_pair_long, a 150 bp read planted 3 times: x 2 kb equal to the oracle, with max_cells= too; "
          f"x {LONG_N} bp equal to sites_for_ref_long_batched (cells by K2); launches of the 2 kb call {pl_launches}; "
          f"{time.perf_counter() - t_pl:.2f} s", flush=True)

    clock.done(2)

    with tempfile.TemporaryDirectory(prefix="swtorch_smoke_") as work:
        # -- 3/4: the main path; launch counts cover exactly these runs ----
        slice_root = os.path.join(work, "slice")
        refseq_like(os.path.join(slice_root, "refs"), 1_000_000, seed=SEED + 3)
        reads_file(os.path.join(slice_root, "inputs", "input1.fa"), 512, seed=SEED + 4)
        reads_file(os.path.join(slice_root, "inputs", "input2.fa"), 2000, seed=SEED + 5)

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
        clock.lap(3)
        scale_root = os.path.join(work, "scale")
        corpus = scale_corpus(scale_root, long_len=LONG_N, seed=SEED + 6)

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
        fail_unless(launches["lane_best_packed_varlen"] > 0 and launches["argmax_lane"] > 0,
                    f"a kernel of the batch path never launched: {launches}")
        k1_main_forms = collections.Counter(cuda_score.K1_FORMS)  # K1's forms on the main-path legs
        k8_main_forms = collections.Counter(cuda_score.K8_FORMS)  # K8's
        k2_main_forms = collections.Counter(cuda_score.K2_FORMS)  # K2's
        fail_unless(k2_main_forms["s16x2"] == launches["argmax_lane"],
                    f"K2 launches of phases 3-4 not all in the s16x2 form: {dict(k2_main_forms)}")
        fail_unless(k1_main_forms["s16x2"] == launches["lane_best_packed_varlen"],
                    f"K1 launches of phases 3-4 not all in the s16x2 form: {dict(k1_main_forms)}")

        ref_bp, scale_read_bp = corpus["ref_bp"], corpus["read_bp"]
        parse_t = time.perf_counter()
        scale_refs = [rec for path in iter_files(config.ref_dir) for rec in get_ref_seqs(path, ">gi")]
        parse_s = time.perf_counter() - parse_t
        fail_unless(sum(len(s) for _, s in scale_refs) == ref_bp, "scale corpus size mismatch")
        print(f"[4] run_pipeline: 512 reads ({scale_read_bp} bp) x {len(scale_refs)} refs ({ref_bp} bp, "
              f"{corpus['files']} files): wall {scale_s:.3f} s, real {scale_read_bp * ref_bp / scale_s / 1e9:.1f} GCUPS; "
              f"host parse {parse_s:.3f} s", flush=True)
        print(f"[4] launches over phases 3-4: {launches}; K1 forms {dict(k1_main_forms)}; the traceback's "
              f"{traced(launches, 'phases 3-4')}", flush=True)

        clock.lap(4)

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

        clock.done(3)
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

        clock.done(4)

        # -- 5. K3 against its plain version ---------------------------------
        def k3_err(got, want, start_t, c):
            """Max abs error of K3's (lane_best, bnd_out) at every start lane and every bnd_out lane."""
            lane = (got[0].reshape(c, -1)[:, start_t] - want[0].reshape(c, -1)[:, start_t]).abs().max()
            return max(int(lane), int((got[1] - want[1]).abs().max()))

        def k3_case(reads, refs, m_pack, segs, row_multiple=8, plain=True, given=()):
            """K3's inputs for each of ``segs`` segments of every ref (one
            flat buffer read by offset, random left columns), the start
            lanes, and the max abs error against the plain version over
            every start lane and every bnd_out lane of the public wrapper
            and of each (form, split) in ``given``."""
            packed, start = pack_reads(reads, m_pack, row_multiple)
            flat, lens = encode_concat(refs)
            offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
            ns = np.maximum(1, -(-lens // segs)).astype(np.int32)
            packed_t, flat_t, ns_t = up(packed), up(flat), up(ns)
            start_t = up(start.astype(np.int64))
            calls, err = [], 0
            for k in range(segs):
                seg_lens = np.clip(lens - k * ns, 0, ns).astype(np.int32)
                seg_offs = np.where(seg_lens > 0, offsets + k * ns, 0).astype(np.int64)
                bnd = up(rng.integers(0, 120, size=(len(refs),) + packed.shape).astype(np.int32))
                args = (packed_t, flat_t, up(seg_offs), up(seg_lens), ns_t, bnd, *PARAMS)
                calls.append(args)
                if plain:
                    want = cuda_score.band_lane_best_plain(*args)
                    outs = [cuda_score.band_lane_best(*args)]
                    outs += [cuda_score._band_lane_best(*args, form=f, split=sp) for f, sp in given]
                    err = max([err] + [k3_err(o, want, start_t, len(refs)) for o in outs])
            return calls, start_t, err

        def k3_plan(args):
            """(stride, look-back) of the public wrapper's column pieces for K3's args."""
            rows, m = args[0].shape
            per_block = 8 if cuda_score.k3_form(m, *PARAMS) == "s16x2" else 4
            return cuda_score.band_segments(m, int(args[4].clamp_min(1).sum()), args[4].shape[0],
                                            -(-rows // per_block), *PARAMS, sms)

        reads_5 = rand_seqs(rng, rng.integers(80, 151, size=512))
        refs_5 = rand_seqs(rng, rng.integers(500, 4000, size=32))
        k3_max_err = 0
        cuda_score.reset_launches()
        for segs in (1, 2, 4):
            # one segment: the int32 form too, and the 16-bit form as one piece
            calls_5, start_5, err = k3_case(reads_5, refs_5, 256, segs,
                                            given=(("int32", False), ("s16x2", False)) if segs == 1 else ())
            k3_max_err = max(k3_max_err, err)
            if segs == 1:
                args_5 = calls_5[0]
        fail_unless(k3_max_err == 0, f"K3 differs from plain (max abs err {k3_max_err})")
        k3_forms_5 = dict(cuda_score.K3_FORMS)
        fail_unless(k3_forms_5 == {"s16x2": 8, "int32": 1},
                    f"K3's public wrapper did not take the s16x2 form at 256 lanes: {k3_forms_5}")
        # The shard_seq leg's read shape (256 reads, m_pack 256) on segments
        # of 8-16 kb, as phase 6 gives K3: the public wrapper cuts them into
        # pieces; the 16-bit form as one piece too.
        reads_5m = rand_seqs(rng, rng.integers(80, 151, size=256))
        refs_5m = rand_seqs(rng, rng.integers(16_000, 32_001, size=4))
        calls_5m, _, err = k3_case(reads_5m, refs_5m, 256, 2, given=(("s16x2", False),))
        plan_5m = k3_plan(calls_5m[0])
        fail_unless(err == 0 and plan_5m[0] < int(calls_5m[0][4].sum()),
                    f"K3 at 8-16 kb segments differs from plain ({err}) or was not cut (plan {plan_5m})")
        k3_max_err = max(k3_max_err, err)
        for m_pack in (128, 512):
            _, _, err = k3_case(edge_reads, edge_refs, m_pack, 3, row_multiple=32, given=(("int32", True),))
            fail_unless(err == 0, f"K3 edge cases differ at m_pack={m_pack} ({err})")
        # The 16-bit form against the int32 form at the contract's edges: the
        # left column 0 and match x m at every lane, reads copied from the
        # segment's start (so a lane reaches bnd + match x 255), under a
        # scheme just inside k3_form's rule (match 64 at 256 lanes: 64 x 511
        # = 32,704 <= 32,767), at mismatch = gap = -32,768 too, and one just
        # outside (match 65): there the public wrapper takes int32 and the
        # s16x2 form given raises.
        ref_e5 = rand_seqs(rng, [6000])[0]
        reads_e5 = [ref_e5[j : j + 256] for j in (0, 3, 100, 1000)] + rand_seqs(rng, rng.integers(80, 257, size=60))
        packed_e5, start_e5 = pack_reads(reads_e5, 256)
        flat_e5, lens_e5 = encode_concat([ref_e5, ref_e5[:3000]])
        start_e5 = up(start_e5.astype(np.int64))
        edge_top = {}
        for params in ((64, -3, -4), (64, -32768, -32768), (65, -3, -4)):
            inside = cuda_score.k3_form(256, *params) == "s16x2"
            for fill in (0, params[0] * 256):
                args = (up(packed_e5), up(flat_e5), up(np.array([0, 6000], np.int64)), up(lens_e5.astype(np.int32)),
                        up(lens_e5.astype(np.int32)),
                        torch.full((2,) + packed_e5.shape, fill, dtype=torch.int32, device=dev))
                want = cuda_score._band_lane_best(*args, *params, form="int32", split=False)
                cuda_score.reset_launches()
                got = [cuda_score.band_lane_best(*args, *params)]
                fail_unless(cuda_score.K3_FORMS["s16x2" if inside else "int32"] == 1,
                            f"K3 took {cuda_score.K3_FORMS} under {params}")
                if inside:
                    got.append(cuda_score._band_lane_best(*args, *params, form="s16x2", split=False))
                else:
                    try:
                        cuda_score._band_lane_best(*args, *params, form="s16x2")
                        fail_unless(False, f"K3's s16x2 form was given under {params}, outside its rule")
                    except ValueError:
                        pass
                err = max(k3_err(g, want, start_e5, 2) for g in got)
                fail_unless(err == 0, f"K3's forms differ at the contract's edge {params}, bnd {fill} ({err})")
                edge_top[params, fill] = int(want[0].max())
        fail_unless(edge_top[(64, -3, -4), 64 * 256] >= 32_000,
                    f"the edge case does not reach the rule's edge: {edge_top}")
        torch.cuda.synchronize()
        k3_plain_t = time.perf_counter()
        cuda_score.band_lane_best_plain(*args_5)
        torch.cuda.synchronize()
        k3_plain_ms = (time.perf_counter() - k3_plain_t) * 1e3

        def k3_turns(args, iters):
            """Kernel ms of the public wrapper (as the ring calls it, the
            columns given), the 16-bit form as one piece and the int32 form
            as one piece, in turns in one pass (device_ms)."""
            cols = int(args[4].clamp_min(1).sum())
            return dict(zip(("public", "unsplit", "int32"), device_ms([
                lambda: cuda_score.band_lane_best(*args, carry_cols=cols),
                lambda: cuda_score._band_lane_best(*args, form="s16x2", split=False),
                lambda: cuda_score._band_lane_best(*args, form="int32", split=False),
            ], iters, entries=("swt_band_lane_best", "swt_band_lane_best_s16x2"))))

        def k3_bound(reads, args):
            nbytes = sum(t.numel() * t.element_size() for t in args[:6]) + 2 * args[5].numel() * 4
            return bound(sum(map(len, reads)) * int(args[3].sum()), nbytes, sms, clock_mhz)

        k3_t = k3_turns(args_5, 10)
        k3_ms = k3_t["public"]
        k3_bound_ms, k3_bound_by = k3_bound(reads_5, args_5)
        print(f"[5] K3 512 reads x 32 refs (500-4000 bp) in 1, 2 and 4 segments, random left columns: max abs err 0 "
              f"at every start lane and bnd_out lane (one segment: public, int32 and s16x2 as one piece; forms "
              f"{k3_forms_5}); 256 reads x 4 refs of 16-32 kb in 2 segments (8-16 kb, plan "
              f"{plan_5m}) equal, s16x2 as one piece too; edge cases (m_pack 128 and 512, 3 segments; int32 too) "
              f"equal; the contract's edges (bnd 0 and match x 256; largest lane {edge_top}) s16x2 equal to int32, "
              f"match 65 int32 only; one segment, kernel ms in turns: public {k3_ms:.3f}, s16x2 as one piece "
              f"{k3_t['unsplit']:.3f}, int32 {k3_t['int32']:.3f}; plain {k3_plain_ms:.1f} ms; bound "
              f"{k3_bound_ms:.3f} ms by {k3_bound_by} = {100 * k3_bound_ms / k3_ms:.1f}% of the public kernel's "
              f"time", flush=True)

        calls_l, start_l_t, _ = k3_case(reads_l, refs_l, 256, 4, plain=False)

        def chain():
            bnd, best = torch.zeros_like(calls_l[0][5]), None
            for args in calls_l:
                lane, bnd = cuda_score.band_lane_best(*args[:5], bnd, *PARAMS)
                got = lane.reshape(len(refs_l), -1)[:, start_l_t]
                best = got if best is None else torch.maximum(best, got)
            return best

        k1_l = read_best(k1(cuda_score.lane_best_packed_varlen, args_l), start_l).T
        fail_unless(torch.equal(chain(), k1_l), "4 chained K3 segments differ from K1 at 131 kb")
        args_5l = calls_l[1]  # the second segment, with a random left column
        want_5l = cuda_score._band_lane_best(*args_5l, form="int32", split=False)
        for form in ("s16x2", "int32"):  # each form cut into pieces; the 16-bit one piece is held above
            err = k3_err(cuda_score._band_lane_best(*args_5l, form=form), want_5l, start_l_t, len(refs_l))
            fail_unless(err == 0, f"K3 {form} in pieces differs from the int32 kernel at 131 kb ({err})")
        plan_5l = k3_plan(args_5l)
        fail_unless(plan_5l[0] < int(args_5l[4].sum()), f"K3 did not cut the 131 kb quarter: {plan_5l}")
        k3l_t = k3_turns(args_5l, 5)
        k3l_ms = k3l_t["public"]
        chain_ms = cuda_ms(chain, 3)
        k3l_bound_ms, k3l_bound_by = k3_bound(reads_l, args_5l)
        print(f"[5] K3 64 reads x 8 refs of {LONG_N} bp in 4 segments: chained equal to K1 at every start lane; "
              f"the second segment (random left column) cut into pieces (stride {plan_5l[0]}, look-back "
              f"{plan_5l[1]}) in both forms equal to the int32 kernel as one piece; kernel ms in turns: "
              f"public {k3l_ms:.3f}, s16x2 as one piece {k3l_t['unsplit']:.3f}, int32 {k3l_t['int32']:.3f} (bound "
              f"{k3l_bound_ms:.3f} ms by {k3l_bound_by}, {100 * k3l_bound_ms / k3l_ms:.1f}% of the public kernel's); "
              f"the chain of 4 with its start-lane max {chain_ms:.3f} ms (K1 on the whole refs {kl_ms:.3f} ms)",
              flush=True)
        # A launch of mixed lengths: one 1 Mb segment among 8 kb ones, the
        # shard_seq leg's 256 reads; held to the int32 kernel as one piece.
        refs_5x = rand_seqs(rng, [1_000_000] + [8_000] * 15)
        (args_5x,), start_5x, _ = k3_case(reads_5m, refs_5x, 256, 1, plain=False)
        want_5x = cuda_score._band_lane_best(*args_5x, form="int32", split=False)
        err = k3_err(cuda_score.band_lane_best(*args_5x), want_5x, start_5x, len(refs_5x))
        fail_unless(err == 0, f"K3 on the mixed-length launch differs from the int32 kernel ({err})")
        k3_max_err = max(k3_max_err, err)
        plan_5x = k3_plan(args_5x)
        k3x_t = k3_turns(args_5x, 2)
        k3x_bound_ms, _ = k3_bound(reads_5m, args_5x)
        print(f"[5] K3 256 reads x one 1 Mb segment and 15 of 8 kb: the public wrapper (stride {plan_5x[0]}, "
              f"{len(cuda_score.band_pieces(1_000_000, *plan_5x))} pieces of the 1 Mb) equal to the int32 kernel as "
              f"one piece; kernel ms in turns: public {k3x_t['public']:.3f}, s16x2 as one piece "
              f"{k3x_t['unsplit']:.3f}, int32 {k3x_t['int32']:.3f} (bound {k3x_bound_ms:.3f} ms)", flush=True)
        clock.done(5)

        # -- 6. shard_seq at real size ---------------------------------------
        seq_root = os.path.join(work, "seq")
        seq_corpus = long_ref_corpus(seq_root, 16_000_000, 256, seed=SEED + 7)
        seq_cells = seq_corpus["read_bp"] * seq_corpus["ref_bp"]

        def align(root, strategy, out):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli.main([
                "align", "--strategy", strategy, "--ref-dir", os.path.join(root, "refs"),
                "--in-dir", os.path.join(root, "inputs"), "--out-dir", os.path.join(root, out),
            ])
            torch.cuda.synchronize()
            fail_unless(rc == 0, f"swtorch align --strategy {strategy} exited {rc}")
            return time.perf_counter() - t

        cuda_score.reset_launches()
        seq_s = align(seq_root, "shard_seq", "out_seq")
        seq_launches = dict(cuda_score.LAUNCHES)
        k3_main_forms = dict(cuda_score.K3_FORMS)
        fail_unless(seq_launches["band_lane_best"] > 0 and k3_main_forms["s16x2"] == seq_launches["band_lane_best"],
                    f"K3 never launched, or not in the s16x2 form, on the shard_seq path: {seq_launches}, "
                    f"{k3_main_forms}")
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        cuda_score.reset_launches()
        batch_s = align(seq_root, "batch", "out_batch")
        seq_batch_launches = dict(cuda_score.LAUNCHES)
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        fail_unless(seq_launches["max_cells_row"] + seq_batch_launches["max_cells_row"] > 0,
                    f"K8 never launched in phase 6: {seq_launches}, {seq_batch_launches}")
        traced_6 = (traced(seq_launches, "phase 6, shard_seq"), traced(seq_batch_launches, "phase 6, batch"))
        fail_unless(stripped(os.path.join(seq_root, "out_seq", "result1.txt"))
                    == stripped(os.path.join(seq_root, "out_batch", "result1.txt")),
                    "shard_seq report differs from batch's")
        print(f"[6] swtorch align on {seq_corpus['n_refs']} refs of 8 kb-1 Mb ({seq_corpus['ref_bp']} bp) x 256 reads "
              f"({seq_corpus['read_bp']} bp): shard_seq {seq_s:.3f} s ({seq_cells / seq_s / 1e9:.1f} real GCUPS), "
              f"batch {batch_s:.3f} s ({seq_cells / batch_s / 1e9:.1f} real GCUPS); reports equal apart from the time "
              f"line; launches of shard_seq {seq_launches} (K3 forms {k3_main_forms}), of batch {seq_batch_launches}; "
              f"the traceback's: shard_seq {traced_6[0]}, batch {traced_6[1]}", flush=True)

        seq_reads = get_reads(os.path.join(seq_root, "inputs", "input1.fa"), ">gi")
        seq_refs = [rec for path in iter_files(os.path.join(seq_root, "refs")) for rec in get_ref_seqs(path, ">gi")]
        seq_seqs = [seq for _, seq in seq_refs]
        seq_config = AlignConfig(ref_dir=seq_root, in_dir=seq_root, out_dir=seq_root, strategy="shard_seq")

        def timed_totals(backend):
            backend.totals(seq_reads, seq_seqs[:2])  # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            totals = backend.totals(seq_reads, seq_seqs)
            return totals, time.perf_counter() - t

        want_seq, batch_tot_s = timed_totals(TorchBatchBackend(seq_config, dev))
        one_seq, one_tot_s = timed_totals(SeqParallelBackend(seq_config, device=dev))
        four = SeqParallelBackend(seq_config, build_mesh(axis_names=("seq",), devices=[dev] * 4))
        four_seq, four_tot_s = timed_totals(four)
        fail_unless(np.array_equal(one_seq, want_seq), "shard_seq totals differ from batch's")
        fail_unless(np.array_equal(four_seq, want_seq), "shard_seq totals on a 4-entry mesh differ from batch's")
        max_score, winners = parse_report(os.path.join(seq_root, "out_seq", "result1.txt"))
        seq_by_meta = dict(seq_refs)
        seq_reads_t = up(encode_batch(seq_reads, 152, READ_PAD))
        for meta in winners:
            seq = seq_by_meta[meta]
            total = int(score_grid(seq_reads_t, up(encode_batch([seq], len(seq), REF_PAD)), *PARAMS).sum())
            fail_unless(total == max_score, f"shard_seq winner {meta}: total {total} != reported {max_score}")
        print(f"[6] totals only: batch {batch_tot_s:.3f} s, shard_seq {one_tot_s:.3f} s, shard_seq on 4 entries of "
              f"{dev} {four_tot_s:.3f} s: all equal; winners {sorted(winners)} (lengths "
              f"{[len(seq_by_meta[w]) for w in winners]}) total {max_score}, equal to the row-form recurrence", flush=True)
        # The band ring enqueues its rounds without a host sync or an upload:
        # every upload first (as SeqParallelBackend._totals_dev makes them),
        # then one _band_ring call under sync debug mode "error", so that a
        # sync that creeps into it (or into K3's wrapper) fails the run.
        one = SeqParallelBackend(seq_config, device=dev)
        pp = one._prepack(seq_reads)
        flat_6, lens_6 = encode_concat(seq_seqs)
        offs_6 = np.concatenate(([0], np.cumsum(lens_6)[:-1])).astype(np.int64)
        chunks_6 = one._chunks(lens_6, pp)
        order_6 = np.concatenate(chunks_6)
        tables_6 = _segment_tables(lens_6[order_6], offs_6[order_6], 1)
        refs_on, tables_on = _upload_refs(flat_6, tables_6, one._devices)
        ends_6 = np.cumsum([len(chunk) for chunk in chunks_6])
        bounds_6 = [(int(end - len(chunk)), int(end)) for end, chunk in zip(ends_6, chunks_6)]
        torch.cuda.synchronize()
        cuda_score.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ring_bests = _band_ring(pp, refs_on, tables_on, tables_6[2], bounds_6, one._params, one._devices)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ring_totals = np.zeros(len(seq_seqs), np.int64)
        for (lo, hi), best in zip(bounds_6, ring_bests):
            ring_totals[order_6[lo:hi]] = best.sum(dim=1, dtype=torch.int64).cpu().numpy()
        fail_unless(np.array_equal(ring_totals, want_seq) and cuda_score.K3_FORMS["s16x2"] > 0,
                    f"the band ring under sync debug mode differs from batch's totals ({cuda_score.K3_FORMS})")
        print(f"[6] _band_ring under torch.cuda.set_sync_debug_mode('error'): {len(bounds_6)} chunk(s), "
              f"{cuda_score.K3_FORMS['s16x2']} K3 launch(es) in s16x2, no sync; totals equal batch's", flush=True)
        clock.done(6)

        # -- 7. shard_refs and shard_reads -------------------------------------
        cuda_score.reset_launches()
        for strategy in ("shard_refs", "shard_reads"):
            shard_s = align(slice_root, strategy, f"out_{strategy}")
            for k in (1, 2):
                fail_unless(stripped(os.path.join(slice_root, f"out_{strategy}", f"result{k}.txt"))
                            == stripped(os.path.join(slice_root, "out", f"result{k}.txt")),
                            f"{strategy} result{k}.txt differs from batch's")
            print(f"[7] swtorch align --strategy {strategy}: 2 inputs x 1 Mbp in {shard_s:.2f} s, reports equal to "
                  f"batch's apart from the time line", flush=True)
        shard_launches = dict(cuda_score.LAUNCHES)
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        fail_unless(shard_launches["lane_best_packed_varlen"] > 0, f"K1 never launched on the sharded path: {shard_launches}")
        fail_unless(cuda_score.K1_FORMS["s16x2"] == shard_launches["lane_best_packed_varlen"],
                    f"K1 launches of phase 7 not all in the s16x2 form: {cuda_score.K1_FORMS}")
        k1_main_forms.update(cuda_score.K1_FORMS)
        mesh22 = ShardedBackend(
            AlignConfig(ref_dir=".", in_dir=".", out_dir=".", strategy="shard_refs"),
            build_mesh((2, 2), devices=[dev] * 4),
        )
        slice_seqs = [seq for _, seq in slice_refs]
        for k in (1, 2):
            reads = get_reads(os.path.join(slice_root, "inputs", f"input{k}.fa"), ">gi")
            want = TorchBatchBackend(config, dev).totals(reads, slice_seqs)
            fail_unless(np.array_equal(mesh22.totals(reads, slice_seqs), want), f"(2, 2) mesh totals differ for input{k}")
        print(f"[7] ShardedBackend on a (2, 2) mesh of {dev}: totals equal batch's for both inputs; "
              f"sharded launches {shard_launches}", flush=True)

        clock.done(7)

        # -- 8. K4 and K5 against their plain versions; K1's TPU modes -----
        def grid_args(reads, refs, m_pad):
            n_pad = max(1, max(map(len, refs)))
            return up(encode_batch(reads, m_pad, READ_PAD)), up(encode_batch(refs, n_pad, REF_PAD))

        def max_err(a, b):
            return int((a.to(torch.int64) - b).abs().max()) if a.numel() else 0

        def host_ms(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        def k4_err(args, want, params=PARAMS, form="s16x2"):
            """Max abs error of K4 against ``want``, failing unless the
            wrapper took ``form`` by its rule, and of its int32 form."""
            got, forms = by_form(cuda_score.K4_FORMS, lambda: cuda_score.score_grid_diag(*args, *params))
            fail_unless(forms[form] == 1, f"K4 took {forms} at m={args[0].shape[1]}, scheme {params}, not {form}")
            return max(max_err(got, want), max_err(cuda_score._score_grid_diag(*args, *params, form="int32"), want))

        def k5_err(args, want, params=PARAMS, form="s16x2", split=True):
            """The same for K5 (each form's references split into segments
            as the wrapper plans, or, with split=False, as one segment)."""
            got, forms = by_form(cuda_score.K5_FORMS,
                                 lambda: cuda_score._score_grid_row(*args, *params, split=split))
            fail_unless(forms[form] == 1, f"K5 took {forms} at m={args[0].shape[1]}, scheme {params}, not {form}")
            int32 = cuda_score._score_grid_row(*args, *params, form="int32", split=split)
            return max(max_err(got, want), max_err(int32, want))

        reads_8 = rand_seqs(rng, rng.integers(80, 151, size=512))
        refs_8 = rand_seqs(rng, rng.integers(500, 4000, size=64))
        args_8 = grid_args(reads_8, refs_8, 256)
        k4_8 = cuda_score.score_grid_diag(*args_8, *PARAMS)
        p4_8, k4_plain_ms = host_ms(lambda: cuda_score.score_grid_diag_plain(*args_8, *PARAMS))
        k5_8 = cuda_score.score_grid_row(*args_8, *PARAMS)
        p5_8, k5_plain_ms = host_ms(lambda: score_grid(*args_8, *PARAMS))
        k4_max_err, k5_max_err = k4_err(args_8, p4_8), k5_err(args_8, p5_8)
        fail_unless(k4_max_err == 0, f"K4 differs from plain at 512 x 64 ({k4_max_err})")
        fail_unless(k5_max_err == 0, f"K5 differs from the row-form recurrence at 512 x 64 ({k5_max_err})")
        fail_unless(torch.equal(k4_8, k5_8), "K4 and K5 differ at 512 x 64")
        for kw in (dict(window_mode="carry"), dict(state_dtype="int16"), dict(state_dtype="int32")):
            fail_unless(torch.equal(cuda_score.score_grid_diag(*args_8, *PARAMS, **kw), k4_8), f"K4 with {kw} differs")
        # The reads at the width of their longest read (150 lanes, L = 5), as
        # the batch backend now passes a read group.
        args_150 = grid_args(reads_8, refs_8, max(map(len, reads_8)))
        fail_unless(k4_err(args_150, p4_8) == 0, "K4 at the reads' longest read differs from plain")
        fail_unless(k5_err(args_150, p5_8) == 0, "K5 at the reads' longest read differs from plain")
        cells_8 = sum(map(len, reads_8)) * sum(map(len, refs_8))
        bytes_8 = sum(t.numel() for t in args_8) + 4 * len(reads_8) * len(refs_8)
        grid_bound_ms, grid_bound_by = bound(cells_8, bytes_8, sms, clock_mhz)
        k4_150_bound_ms, _ = bound(cells_8, sum(t.numel() for t in args_150) + 4 * len(reads_8) * len(refs_8),
                                   sms, clock_mhz)
        print(f"[8] K4 and K5, 512 reads (80-150 bp in 256 lanes) x 64 refs (500-4000 bp), every pair: max abs err 0 "
              f"against plain (K4) and the row-form recurrence (K5), each in both forms, also at "
              f"{args_150[0].shape[1]} lanes, equal to each other, K4 window_mode='carry' and state_dtype='int16' and "
              f"'int32' equal; K4 plain {k4_plain_ms:.1f} ms, K5 plain {k5_plain_ms:.1f} ms; bound "
              f"{grid_bound_ms:.3f} ms by {grid_bound_by} ({cells_8:.3e} cells, {bytes_8} bytes)", flush=True)

        args_8l = grid_args(reads_l, refs_l[:2], 152)
        want_8l = score_grid(*args_8l, *PARAMS)
        err = k4_err(args_8l, want_8l)
        fail_unless(err == 0, f"K4 at 131 kb refs differs from the row-form recurrence ({err})")
        # 16 reads against one 131 kb ref: K5's 2 blocks (4 in int32) split
        # into column segments, and again as one segment.
        args_8r = (args_8l[0][:16], args_8l[1][:1])
        want_8r = want_8l[:16, :1]
        err5 = max(k5_err(args_8r, want_8r), k5_err(args_8r, want_8r, split=False))
        fail_unless(err5 == 0, f"K5 at a 131 kb ref differs from the row-form recurrence ({err5})")
        fail_unless(torch.equal(cuda_score.score_grid_row(*args_8r, *PARAMS), cuda_score.score_grid_diag(*args_8r, *PARAMS)),
                    "K5 and K4 differ at 131 kb")
        k5_stride, k5_seg_len = cuda_score.row_segments(args_8r[0].shape[1], LONG_N, *PARAMS, 2, sms)
        k5_segments = -(-LONG_N // k5_stride)
        fail_unless(k5_segments > 1, f"K5 does not split 16 reads x one {LONG_N} bp ref ({k5_stride})")
        k4l_bound_ms, _ = bound(sum(map(len, reads_l)) * 2 * LONG_N, sum(t.numel() for t in args_8l) + 4 * 64 * 2,
                                sms, clock_mhz)
        cells_8r = sum(map(len, reads_l[:16])) * LONG_N
        k5l_bound_ms, _ = bound(cells_8r, sum(t.numel() for t in args_8r) + 4 * 16, sms, clock_mhz)
        k5_unsplit_ms = cuda_ms(lambda: cuda_score._score_grid_row(*args_8r, *PARAMS, split=False), 3)
        print(f"[8] K4 (both forms) 64 reads x 2 refs of {LONG_N} bp, K5 (both forms) 16 reads x one in {k5_segments} "
              f"segments of {k5_seg_len} columns every {k5_stride} and as one segment: equal to the row-form recurrence "
              f"and to each other; K5 s16x2 as one segment {k5_unsplit_ms:.3f} ms (bound {k5l_bound_ms:.3f} ms)",
              flush=True)

        def k45_turns(k, fn, args, iters, cells, bound_ms):
            """{form: mean ms} of K4's or K5's two forms on the same inputs
            (:func:`in_turns`), which must agree."""
            turns, outs = in_turns(lambda form: fn(*args, *PARAMS, form=form), iters)
            fail_unless(torch.equal(outs["int32"], outs["s16x2"]), f"{k}'s two forms differ at {tuple(args[0].shape)}")
            ab = {form: float(np.mean(v)) for form, v in turns.items()}
            s16, i32 = ab["s16x2"], ab["int32"]
            print(f"[8] {k} {tuple(args[0].shape)} reads x {tuple(args[1].shape)} refs, in turns int32 "
                  f"{turns['int32'][0]:.3f}, s16x2 {turns['s16x2'][0]:.3f}, s16x2 {turns['s16x2'][1]:.3f}, int32 "
                  f"{turns['int32'][1]:.3f} ms: s16x2 {s16:.3f} ms ({cells / s16 / 1e6:.1f} "
                  f"GCUPS real cells, {100 * bound_ms / s16:.1f}% of the bound), int32 {i32:.3f} ms "
                  f"({100 * bound_ms / i32:.1f}%), int32/s16x2 {i32 / s16:.2f}x; bound {bound_ms:.3f} ms", flush=True)
            return ab

        # Each kernel's two forms in turns on the same inputs: 256 lanes (the
        # kernel table's row), the same reads at 150 lanes, and the 131 kb
        # refs (K5: 16 reads x one, split).
        cells_8l = sum(map(len, reads_l)) * 2 * LONG_N
        k4_ab = {key: k45_turns("K4", cuda_score._score_grid_diag, *case)
                 for key, *case in (("256", args_8, 10, cells_8, grid_bound_ms),
                                    ("150", args_150, 10, cells_8, k4_150_bound_ms),
                                    ("131k", args_8l, 3, cells_8l, k4l_bound_ms))}
        k5_ab = {key: k45_turns("K5", cuda_score._score_grid_row, *case)
                 for key, *case in (("256", args_8, 10, cells_8, grid_bound_ms),
                                    ("150", args_150, 10, cells_8, k4_150_bound_ms),
                                    ("131k", args_8r, 3, cells_8r, k5l_bound_ms))}
        k4_ms, k4_int32_ms = k4_ab["256"]["s16x2"], k4_ab["256"]["int32"]
        k4l_ms = k4_ab["131k"][cuda_score.k1_form(args_8l[0].shape[1], *PARAMS)]
        fail_unless(k4_ms < k4_int32_ms, "K4's s16x2 form is not faster than its int32 form at 256 lanes")
        k5_ms, k5_int32_ms = k5_ab["256"]["s16x2"], k5_ab["256"]["int32"]
        fail_unless(k5_ms < k5_int32_ms, "K5's s16x2 form is not faster than its int32 form at 256 lanes")

        # The s16x2 form's own edges: an odd number of reads (the last pairs
        # with an all-pad read), gap and mismatch -32,768, a 1,024 bp read
        # against itself at match 31 (s16x2) and 32 (int32).
        args_odd = (args_8[0][:201], args_8[1][:16])
        args_g = (args_8[0][:64], args_8[1][:32])
        args_b = grid_args([read_b], [read_b], 1024)
        for k, err_of, counts, fn in (("K4", k4_err, cuda_score.K4_FORMS, cuda_score.score_grid_diag),
                                      ("K5", k5_err, cuda_score.K5_FORMS, cuda_score.score_grid_row)):
            err_odd = err_of(args_odd, p4_8[:201, :16])
            err_gap = max(err_of(args_g, cuda_score.score_grid_diag_plain(*args_g, *params), params)
                          for params in ((5, -3, -32768), (5, -32768, -32768)))
            boundary = {}
            for params, form in (((31, -3, -4), "s16x2"), ((32, -3, -4), "int32")):
                got, forms = by_form(counts, lambda: fn(*args_b, *params))
                fail_unless(forms[form] == 1, f"{k} at m=1024, scheme {params} took {forms}, not {form}")
                boundary[params[0]] = int(got[0, 0])
                fail_unless(boundary[params[0]] == 1024 * params[0] == int(score_grid(*args_b, *params)[0, 0])
                            and err_of(args_b, score_grid(*args_b, *params), params, form) == 0,
                            f"{k} on a 1,024 bp read equal to its ref at match {params[0]}: {boundary[params[0]]}")
            fail_unless(max(err_odd, err_gap) == 0, f"{k}'s s16x2 form differs from plain (odd reads {err_odd}, "
                                                    f"gap -32768 {err_gap})")
            print(f"[8] {k} s16x2: {args_odd[0].shape[0]} reads (odd), gap -32768 (and mismatch -32768) equal to plain "
                  f"in both forms; a 1,024 bp read equal to its ref scores {boundary[31]} at match 31 (s16x2) and "
                  f"{boundary[32]} at match 32 (int32), equal to the row-form recurrence", flush=True)

        for m_pad in (128, 1024):
            reads_e = edge_reads + (rand_seqs(rng, [1024, 1000]) if m_pad == 1024 else [])
            args_e = grid_args(reads_e, edge_refs, m_pad)
            want_e = cuda_score.score_grid_diag_plain(*args_e, *PARAMS)
            err = k4_err(args_e, want_e)
            fail_unless(err == 0, f"K4 edge cases differ from plain at m_pad={m_pad} ({err})")
            err = k5_err(args_e, want_e)
            fail_unless(err == 0, f"K5 edge cases differ from plain at m_pad={m_pad} ({err})")
            want = np.array([[oracle.opt_alignments(f, r)[0] for f in edge_refs[:3]] for r in reads_e[:8]])
            fail_unless((want_e[:8, :3].cpu().numpy() == want).all(), f"edge cases differ from the oracle at {m_pad}")
        print("[8] K4 and K5 (both forms) edge cases (a block of 8 reads with empty and 1 bp reads, 0/1 bp refs, "
              "m_pad 128 and 1024 with 1,024 bp reads): equal to plain and oracle", flush=True)

        packed_8, start_8 = pack_reads(reads_8, 256)
        packed_8 = up(packed_8)
        lens_8 = torch.full((len(refs_8),), args_8[1].shape[1], dtype=torch.int32, device=dev)
        want_8 = read_best(cuda_score.lane_best_packed_varlen(packed_8, args_8[1], lens_8, *PARAMS), start_8)
        for mode in cuda_score.LANE_BEST_MODES:
            got = read_best(cuda_score.lane_best_packed(packed_8, args_8[1], *PARAMS, mode=mode), start_8)
            fail_unless(torch.equal(got, want_8), f"lane_best_packed mode={mode} differs from K1")
        print(f"[8] lane_best_packed, modes {', '.join(cuda_score.LANE_BEST_MODES)}, 512 reads x 64 refs padded to "
              f"{args_8[1].shape[1]}: equal to K1 at every start lane", flush=True)

        clock.done(8)

        # -- 9. the unpacked and row paths end to end ----------------------------
        slice_reads = {k: get_reads(os.path.join(slice_root, "inputs", f"input{k}.fa"), ">gi") for k in (1, 2)}
        slice_want = {k: TorchBatchBackend(config, dev).totals(slice_reads[k], slice_seqs) for k in (1, 2)}
        cuda_score.reset_launches()
        config_u = dataclasses.replace(config, out_dir=os.path.join(scale_root, "out_unpacked"), pack_reads=False)
        backend_u = TorchBatchBackend(config_u, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (unpacked_report,) = run_pipeline(config_u, backend=backend_u, device=dev)
        torch.cuda.synchronize()
        unpacked_s = time.perf_counter() - t
        fail_unless(stripped(unpacked_report) == stripped(scale_report), "pack_reads=False scale report differs from phase 4's")
        print(f"[9] run_pipeline pack_reads=False on the phase-4 corpus: wall {unpacked_s:.3f} s, real "
              f"{scale_read_bp * ref_bp / unpacked_s / 1e9:.1f} GCUPS (phase 4 packed: {scale_s:.3f} s); "
              f"report equal to phase 4's apart from the time line", flush=True)
        config_r = AlignConfig(
            ref_dir=os.path.join(slice_root, "refs"), in_dir=os.path.join(slice_root, "inputs"),
            out_dir=os.path.join(slice_root, "out_row"), kernel="row",
        )
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_pipeline(config_r, device=dev)
        torch.cuda.synchronize()
        row_s = time.perf_counter() - t
        for k in (1, 2):
            fail_unless(stripped(os.path.join(slice_root, "out_row", f"result{k}.txt"))
                        == stripped(os.path.join(slice_root, "out", f"result{k}.txt")),
                        f"kernel='row' result{k}.txt differs from phase 3's")
        print(f"[9] run_pipeline kernel='row' on the phase-3 corpus: 2 inputs in {row_s:.2f} s, reports equal to "
              f"phase 3's apart from the time line", flush=True)
        for kw in (dict(pack_reads=False), dict(kernel="row")):
            mesh_u = ShardedBackend(
                AlignConfig(ref_dir=".", in_dir=".", out_dir=".", strategy="shard_refs", **kw),
                build_mesh((2, 2), devices=[dev] * 4),
            )
            for k in (1, 2):
                fail_unless(np.array_equal(mesh_u.totals(slice_reads[k], slice_seqs), slice_want[k]),
                            f"(2, 2) mesh totals with {kw} differ from batch's for input{k}")
        unpacked_launches = dict(cuda_score.LAUNCHES)
        fail_unless(unpacked_launches["score_grid_diag"] > 0 and unpacked_launches["score_grid_row"] > 0,
                    f"K4 or K5 never launched on the unpacked and row paths: {unpacked_launches}")
        fail_unless(cuda_score.K4_FORMS["s16x2"] == unpacked_launches["score_grid_diag"],
                    f"K4 launches of phase 9 not all in the s16x2 form: {cuda_score.K4_FORMS}")
        fail_unless(cuda_score.K5_FORMS["s16x2"] == unpacked_launches["score_grid_row"],
                    f"K5 launches of phase 9 not all in the s16x2 form: {cuda_score.K5_FORMS}")
        k4_main_forms = collections.Counter(cuda_score.K4_FORMS)  # K4's forms on the main-path legs
        k5_main_forms = collections.Counter(cuda_score.K5_FORMS)  # K5's
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        print(f"[9] ShardedBackend with pack_reads=False and with kernel='row' on a (2, 2) mesh of {dev}: totals equal "
              f"batch's for both inputs; launches over phase 9 {unpacked_launches}, K5 forms {cuda_score.K5_FORMS}",
              flush=True)

        clock.done(9)

        # -- 10. swtorch scaling ---------------------------------------------------
        counts = "1,2,4" if torch.cuda.device_count() >= 4 else "1"
        cuda_score.reset_launches()
        for axis, shape in (("refs", ["--num-reads", "512", "--num-refs", "512", "--ref-len", "4096"]),
                            ("seq", ["--num-reads", "256", "--ref-len", "65536"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["scaling", "--axis", axis, "--devices", counts, "--read-len", "128", *shape])
            fail_unless(rc == 0, f"swtorch scaling --axis {axis} exited {rc}")
            print(f"[10] swtorch scaling --axis {axis} {' '.join(shape)} --read-len 128: "
                  f"{json.dumps(json.loads(out.getvalue()))}", flush=True)
        scaling_launches = dict(cuda_score.LAUNCHES)
        fail_unless(scaling_launches["score_grid_diag"] > 0, f"K4 never launched by swtorch scaling: {scaling_launches}")
        fail_unless(cuda_score.K4_FORMS["s16x2"] == scaling_launches["score_grid_diag"],
                    f"K4 launches of phase 10 not all in the s16x2 form: {cuda_score.K4_FORMS}")
        k4_main_forms.update(cuda_score.K4_FORMS)
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        reads_10, refs_10 = workload(512, 128, 512, 4096)
        totals_10 = sharded_totals(reads_10, refs_10, *PARAMS, mesh=build_mesh((1, 1), devices=[dev]))
        sub = np.arange(0, 512, 32)
        want_10 = score_grid(up(reads_10), up(refs_10[sub]), *PARAMS).sum(dim=0, dtype=torch.int64)
        fail_unless(torch.equal(totals_10[torch.as_tensor(sub, device=dev)], want_10),
                    "scaling totals differ from the row-form recurrence")
        print(f"[10] refs totals of 16 of the 512 refs equal the row-form recurrence; launches over phase 10 "
              f"{scaling_launches}", flush=True)

        clock.done(10)

        # -- 11. K6 against its plain version ----------------------------------------
        def chain_reads(rb, m, starts, seed):
            r = np.random.default_rng(seed)
            reads = r.integers(2, 6, size=(rb, m)).astype(np.int32)
            if starts:
                reads[r.random((rb, m)) < 1 / 12] |= 256
            return up(reads)

        def k6_run(reads, form, *args, **kw):
            """K6 through its public wrapper, failing unless it took ``form``."""
            cuda_score.reset_launches()
            got = cuda_score.step_chain_best(reads, *args, **kw)
            fail_unless(cuda_score.K6_FORMS[form] == 1, f"K6 took {cuda_score.K6_FORMS}, not {form}, at "
                                                        f"{tuple(reads.shape)} {kw}")
            return got

        k6 = {}
        # The JAX microbench's inputs (codes 2-5, no start bit): row 0 grows
        # around the ring, so at 131,072 steps the rule gives int32.
        for rb, m in ((512, 128), (248, 256)):
            reads = chain_reads(rb, m, False, 0)
            for masked in (False, True):
                got = k6_run(reads, "int32", steps=LONG_N, unroll=64, masked=masked)
                want, plain_ms = host_ms(lambda: cuda_score.step_chain_best_plain(reads, LONG_N, 64, *PARAMS, masked))
                err = max_err(got, want)
                fail_unless(err == 0, f"K6 {rb} x {m} masked={masked} differs from plain ({err})")
                ms = cuda_ms(lambda: cuda_score.step_chain_best(reads, steps=LONG_N, unroll=64, masked=masked), 5)
                cells = rb * m * LONG_N
                k6[rb, m, masked] = (ms, plain_ms, *bound(cells, 8 * rb * m, sms, clock_mhz))
                print(f"[11] K6 {rb} x {m}, {LONG_N} steps, unroll 64, masked={masked}, the JAX inputs (int32): max abs "
                      f"err 0; kernel {ms:.3f} ms ({cells / ms / 1e6:.1f} padded GCUPS), plain {plain_ms:.1f} ms; bound "
                      f"{k6[rb, m, masked][2]:.3f} ms by {k6[rb, m, masked][3]} = "
                      f"{100 * k6[rb, m, masked][2] / ms:.1f}% of the kernel's time", flush=True)
        # The lane-0 read: the public wrapper reads lane 0 of every row (one
        # reduction and one sync) on each call where the rule needs it, the
        # int32 form given reads nothing.  Both in turns on the JAX inputs.
        reads = chain_reads(512, 128, False, 0)
        chain_ways = {"public": lambda: cuda_score.step_chain_best(reads, steps=LONG_N, unroll=64),
                      "given": lambda: cuda_score._step_chain_best(reads, steps=LONG_N, unroll=64, form="int32")}
        read_turns = collections.defaultdict(list)
        for way in ("public", "given", "given", "public"):
            read_turns[way].append(cuda_ms(chain_ways[way], 10))
        read_ms = float(np.mean(read_turns["public"]) - np.mean(read_turns["given"]))
        print(f"[11] K6 512 x 128, the JAX inputs, in turns: public wrapper (reads lane 0) "
              f"{read_turns['public'][0]:.3f}, int32 given {read_turns['given'][0]:.3f}, "
              f"{read_turns['given'][1]:.3f}, public {read_turns['public'][1]:.3f} ms: the read costs {read_ms:.3f} ms "
              f"a call ({100 * read_ms / np.mean(read_turns['public']):.1f}%)", flush=True)
        # The bench's rows (START_BIT on lane 0 of every row, as each read
        # restarts there): s16x2 at the card-filling rows, against plain; the
        # two forms in turns there and at 512 rows, each agreeing (lane 0
        # read once, outside the timed calls, as the bench does).
        rb_fill, steps_fill = bench.roofline_rows(dev), bench.ROOFLINE_STEPS
        reads_fill = up(roofline_reads(rb_fill, 128, lane0_starts=True))
        got = k6_run(reads_fill, "s16x2", steps=steps_fill, unroll=64)
        want, fill_plain_ms = host_ms(lambda: cuda_score.step_chain_best_plain(reads_fill, steps_fill, 64, *PARAMS,
                                                                               False))
        fail_unless(max_err(got, want) == 0, f"K6 s16x2 {rb_fill} x 128 differs from plain ({max_err(got, want)})")
        k6_turns = {}
        for rb in (512, rb_fill):
            reads = reads_fill if rb == rb_fill else up(roofline_reads(rb, 128, lane0_starts=True))
            starts = cuda_score.lane0_starts(reads)
            k6_turns[rb], outs = in_turns(lambda form: cuda_score._step_chain_best(reads, steps=steps_fill, unroll=64,
                                                                                   form=form, starts=starts), 3)
            fail_unless(torch.equal(outs["int32"], outs["s16x2"]) and (rb != rb_fill or torch.equal(outs["int32"], want)),
                        f"K6's two forms differ (or differ from plain) at {rb} x 128 of the bench's rows")
        fill_bound = bound(rb_fill * 128 * steps_fill, 8 * rb_fill * 128, sms, clock_mhz)
        rows512_bound = bound(512 * 128 * steps_fill, 8 * 512 * 128, sms, clock_mhz)
        print(f"[11] K6 the bench's rows ({rb_fill} = 8 x {sms} SMs x {bench.ROOFLINE_WARPS} rows x 128 lanes, "
              f"lane 0 a start, {steps_fill} steps): s16x2 equal to plain (plain {fill_plain_ms:.1f} ms), int32 equal "
              f"to s16x2; in turns "
              + "; ".join(f"{rb} rows: int32 {t['int32'][0]:.3f}, s16x2 {t['s16x2'][0]:.3f}, s16x2 "
                          f"{t['s16x2'][1]:.3f}, int32 {t['int32'][1]:.3f} ms"
                          f" ({rb * 128 * steps_fill / min(t['s16x2']) / 1e6:.1f} and "
                          f"{rb * 128 * steps_fill / min(t['int32']) / 1e6:.1f} GCUPS)" for rb, t in k6_turns.items())
              + f"; bound {fill_bound[0]:.3f} ms by {fill_bound[1]} at {rb_fill} rows, {rows512_bound[0]:.3f} at 512",
              flush=True)
        # Warps a scheduler: the bench's w must be one that no larger w beats
        # in K6's s16x2 rate by more than 5% (the leg is K4's ceiling).
        w_rates = {}
        for w in (1, 2, 4, 8, 16, 32):
            rb = bench.roofline_rows(dev, w)
            reads = up(roofline_reads(rb, 128, lane0_starts=True))
            starts = cuda_score.lane0_starts(reads)
            steps_w = steps_fill * bench.ROOFLINE_WARPS // w
            w_ms = cuda_ms(lambda: cuda_score._step_chain_best(reads, steps=steps_w, unroll=64, starts=starts), 5)
            w_rates[w] = (rb * 128 * steps_w / w_ms / 1e6, w_ms)
        pick = min(w for w in w_rates if all(r <= 1.05 * w_rates[w][0] for w2, (r, _) in w_rates.items() if w2 > w))
        print(f"[11] K6 s16x2 rate at 8 x {sms} x w rows of 128 lanes (steps x w constant): " + ", ".join(
            f"w={w} {r:.1f} GCUPS ({ms:.3f} ms)" for w, (r, ms) in w_rates.items())
              + f"; the smallest w that no larger w beats by more than 5% is {pick}, the bench runs "
              f"w={bench.ROOFLINE_WARPS}", flush=True)
        fail_unless(max(r for r, _ in w_rates.values()) <= 1.05 * w_rates[bench.ROOFLINE_WARPS][0],
                    f"K6's rate at w={bench.ROOFLINE_WARPS} is beaten by more than 5%: the roofline leg is no ceiling")

        def k6_both(reads, rule_form, steps, unroll, masked=False, params=PARAMS):
            """K6 at the rule's form (through the public wrapper) and in int32
            given, each held to plain: the max abs error and the plain result."""
            want = cuda_score.step_chain_best_plain(reads, steps, unroll, *params, masked)
            kw = dict(steps=steps, unroll=unroll, masked=masked, match=params[0], mismatch=params[1], gap=params[2])
            err = max(max_err(k6_run(reads, rule_form, **kw), want),
                      max_err(cuda_score._step_chain_best(reads, form="int32", **kw), want))
            return err, want

        # The steps bound's edge: row 0 of the microbench's inputs gains 7
        # every two steps, 7 x 4,681 = 32,767 after 9,362 steps (s16x2);
        # two steps more take int32.
        reads = chain_reads(8, 128, False, 1)
        for steps, unroll, form, top in ((9362, 62, "s16x2", 32767), (9364, 2, "int32", 32774)):
            err, want = k6_both(reads, form, steps, unroll, params=(7, -3, -4))
            fail_unless(err == 0 and int(want.max()) == top,
                        f"K6 at the steps bound's edge ({steps} steps, {form}): max {int(want.max())}, err {err}")
        n_small = 0
        for m in (32, 96, 128, 1024):
            for rb, starts in ((8, False), (8, True), (7, True)):
                reads = chain_reads(rb, m, starts, m + rb)
                for unroll, masked in ((8, False), (7, False), (7, True), (1, True), (64, True)):
                    err, _ = k6_both(reads, "s16x2", 1500, unroll, masked)
                    fail_unless(err == 0, f"K6 differs from plain at {rb} x {m}, starts={starts}, unroll={unroll}, "
                                          f"masked={masked} ({err})")
                    n_small += 1
        print(f"[11] K6 in both forms (s16x2 by the rule, int32 given) against plain in {n_small} small cases (8 and "
              f"7 rows of 32, 96, 128 and 1024 lanes, 1,500 steps, unroll 8, 7, 1 and 64, start lanes or not, masked "
              f"or not) and at the steps bound's edge (7/-3/-4, 9,362 steps, row 0 at 32,767; 9,364 steps in int32 "
              f"only, 32,774): max abs err 0", flush=True)

        clock.done(11)

        # -- 12. K7 against its plain version ----------------------------------------
        packed_12 = np.random.default_rng(0).integers(65, 85, size=(248, 256)).astype(np.int32)
        packed_12[:, 0] |= 256  # the JAX script's inputs
        packed_12 = up(packed_12)
        refs_12 = up(encode_batch(rand_seqs(rng, [1024] * 64), 1024, REF_PAD))
        k7, k7_max_err = {}, 0
        cells_12 = 248 * 256 * 64 * 1024
        bytes_12 = packed_12.numel() * 4 + refs_12.numel() + 64 * packed_12.numel() * 4
        k7_bound_ms, k7_bound_by = bound(cells_12, bytes_12, sms, clock_mhz)

        def k7_forms(packed, refs, variant, unroll=16):
            """K7 at the rule's form (through the public wrapper; every
            variant s16x2 but C) and, but for C, in int32 given: {form:
            result}."""
            cuda_score.reset_launches()
            rule_form = "int32" if variant == "C" else "s16x2"
            outs = {rule_form: cuda_score.step_variant_best(packed, refs, variant=variant, unroll=unroll)}
            fail_unless(cuda_score.K7_FORMS[rule_form] == 1,
                        f"K7 {variant} took {cuda_score.K7_FORMS} at {tuple(packed.shape)} x {tuple(refs.shape)}")
            if variant != "C":
                outs["int32"] = cuda_score._step_variant_best(packed, refs, variant=variant, unroll=unroll,
                                                              form="int32")
            return outs

        for variant in cuda_score.STEP_VARIANTS:
            outs = k7_forms(packed_12, refs_12, variant)
            want, plain_ms = host_ms(lambda: cuda_score.step_variant_best_plain(packed_12, refs_12, variant, 16, *PARAMS))
            if variant == "C":
                ms_c = cuda_ms(lambda: cuda_score.step_variant_best(packed_12, refs_12, variant="C"), 10)
                turns = {"int32": [ms_c, ms_c], "s16x2": [None, None]}
            else:
                turns, timed = in_turns(lambda form: cuda_score._step_variant_best(packed_12, refs_12, variant=variant,
                                                                                   form=form), 10)
                outs.update({f"timed {form}": got for form, got in timed.items()})
            k7_max_err = max(k7_max_err, *(max_err(got, want) for got in outs.values()))
            fail_unless(k7_max_err == 0, f"K7 variant {variant} differs from plain in a form ({k7_max_err})")
            k7[variant] = (turns, plain_ms, outs["int32"])
        fail_unless(torch.equal(cuda_score.segmented_suffix_max(k7["E"][2], packed_12 >= 256), k7["A"][2]),
                    "the suffix max of K7's E differs from A")
        fail_unless(torch.equal(k7["C"][2], k7["A"][2]), "K7's C differs from A")
        print(f"[12] K7 248 x 256 x 64 refs of 1024 bp, unroll 16: every variant equal to plain in both forms (A, B, D, "
              f"E; C in int32 only), suffix max of E and C equal to A; in turns int32, s16x2, s16x2, int32: " + "; ".join(
                  f"{v} " + (f"{t['int32'][0]:.3f}, {t['s16x2'][0]:.3f}, {t['s16x2'][1]:.3f}, {t['int32'][1]:.3f} ms "
                             f"({cells_12 / min(t['s16x2']) / 1e6:.1f} padded GCUPS)" if v != "C" else
                             f"int32 only {t['int32'][0]:.3f} ms") + f", plain {p:.1f} ms"
                  for v, (t, p, _) in k7.items())
              + f"; bound {k7_bound_ms:.3f} ms by {k7_bound_by} = "
              f"{100 * k7_bound_ms / min(k7['A'][0]['s16x2']):.1f}% of A's s16x2 time", flush=True)
        n_small = 0
        for m, n, unroll, rows in ((32, 40, 16, 8), (64, 1, 7, 7), (128, 300, 16, 13), (512, 64, 5, 8),
                                   (1024, 100, 16, 7)):
            reads_e = rand_seqs(rng, rng.integers(1, min(m, 150) + 1, size=40)) + [""]
            packed_e = up(pack_reads(reads_e, m, row_multiple=8)[0][:rows])
            refs_e = up(encode_batch(rand_seqs(rng, [n] * 3), n, REF_PAD))
            for variant in cuda_score.STEP_VARIANTS:
                want = cuda_score.step_variant_best_plain(packed_e, refs_e, variant, unroll, *PARAMS)
                for form, got in k7_forms(packed_e, refs_e, variant, unroll).items():
                    err = max_err(got, want)
                    fail_unless(err == 0, f"K7 {variant} {form} differs from plain at {rows} x {m}, n={n}, "
                                          f"unroll={unroll} ({err})")
                    k7_max_err = max(k7_max_err, err)
                n_small += 1
        print(f"[12] K7 against plain in {n_small} small cases (7-13 packed rows of 32-1024 lanes, refs of 1-300 bp, "
              f"unroll 5, 7 and 16; A, B, D, E in both forms, C in int32): max abs err 0", flush=True)

        clock.done(12)

        # -- 13. the port's bench, and the two probes of experiments/ -------------------
        # Full sizes but two cuts: the e2e leg's oracle parity check is pure
        # Python (512 reads take about 3 minutes), and readscale takes 5,000
        # of its 20,000 reads.
        t = time.perf_counter()
        bench_root = os.path.join(work, "bench_corpus")
        result, bench_launches = bench.run_bench(dev, repeats=1, sizes={
            "e2e": dict(n_reads=64),
            "pipeline": dict(corpus_root=bench_root),
            "corpus": dict(corpus_root=bench_root),
            "readscale": dict(n_reads=5_000, corpus_root=bench_root),
        })
        bench_s = time.perf_counter() - t
        fail_unless(tuple(result) == bench.KEYS, f"the bench line's keys differ: {list(result)}")
        fail_unless(result["smoke"] == "pass", f"bench smoke: {result['smoke']}")
        for leg, kernel in (("kernel", "score_grid_diag"), ("e2e", "lane_best_packed_varlen"),
                            ("pipeline", "lane_best_packed_varlen"), ("corpus", "lane_best_packed_varlen"),
                            ("readscale", "lane_best_packed_varlen"), ("longref", "lane_best_packed_varlen"),
                            ("longref", "argmax_lane"), ("longref", "k2_s16x2"), ("roofline", "step_chain_best")):
            fail_unless(bench_launches[leg][kernel] > 0, f"{kernel} never launched on the bench's {leg} leg")
        k6_main_forms, k7_main_forms = collections.Counter(), collections.Counter()  # K6's, K7's on the main path
        for leg, counts in bench_launches.items():
            for k, name in (("k1", "lane_best_packed_varlen"), ("k2", "argmax_lane"), ("k4", "score_grid_diag"),
                            ("k6", "step_chain_best")):
                fail_unless(counts[f"{k}_s16x2"] == counts[name],
                            f"{k.upper()} launches of the bench's {leg} leg not all in the s16x2 form: {counts}")
            for k, forms in (("k1", k1_main_forms), ("k2", k2_main_forms), ("k4", k4_main_forms),
                             ("k6", k6_main_forms), ("k7", k7_main_forms), ("k8", k8_main_forms)):
                forms.update({form: counts[f"{k}_{form}"] for form in cuda_score.K1_FORMS})
        # F8: K4's step rate over K6's, both in the s16x2 form, is a share
        # of a ceiling only if it is at most 100%.
        fail_unless(result["kernel_pct_roofline"] <= 100,
                    f"kernel_pct_roofline {result['kernel_pct_roofline']:.1f}% > 100%: K6 is not a ceiling for K4")
        print(f"[13] bench legs (one pass each, parity against the oracle passed, smoke {result['smoke']}) in "
              f"{bench_s:.1f} s: {json.dumps(result)}", flush=True)
        print(f"[13] launches per bench leg: {json.dumps(bench_launches)}", flush=True)
        from sparksmithwaterman_tpu_torch.experiments import packed_step_variants, triangle_timepack

        probe_launches, probe_forms = {}, {}
        for name, module, argv in (("triangle_timepack", triangle_timepack, ["--steps", "16384"]),
                                   ("packed_step_variants", packed_step_variants, ["--n", "256"])):
            out = io.StringIO()
            cuda_score.reset_launches()
            with contextlib.redirect_stdout(out):
                fail_unless(module.main(argv) == 0, f"experiments.{name} failed")
            probe_launches[name] = dict(cuda_score.LAUNCHES)
            k6_main_forms.update(cuda_score.K6_FORMS)
            k7_main_forms.update(cuda_score.K7_FORMS)
            probe_forms[name] = {"k6": dict(cuda_score.K6_FORMS), "k7": dict(cuda_score.K7_FORMS)}
            for line in out.getvalue().splitlines():
                print(f"[13] {name} {' '.join(argv)}: {line}", flush=True)
        fail_unless(probe_launches["triangle_timepack"]["step_chain_best"] > 0, "K6 never launched by triangle_timepack")
        fail_unless(probe_launches["packed_step_variants"]["step_variant_best"] > 0,
                    "K7 never launched by packed_step_variants")
        # The probes' inputs: the time-packing chain has no start bit (int32
        # at 16,384 steps); the variants' 512 steps admit s16x2 but for C.
        k7_probe = probe_forms["packed_step_variants"]["k7"]
        fail_unless(k7_probe["s16x2"] == 4 * k7_probe["int32"] > 0, f"K7's forms in the probe: {k7_probe}")
        print(f"[13] K6's and K7's forms in the probes: {json.dumps(probe_forms)}", flush=True)

        clock.done(13)

        # -- 14. long reads: K1-K5 on rows wider than 1,024 lanes (stripes) ---------
        t14 = time.perf_counter()
        forms_14 = {k: dict(getattr(cuda_score, f"{k}_FORMS")) for k in ("K1", "K2", "K3", "K4", "K5", "K8")}
        genome = rand_seqs(rng, [40_000])[0]
        # K3's and K8's wide cases draw from a generator of their own, so that
        # the inputs of the rest of the phase and the later phases stay as
        # they were.
        k38_rng = np.random.default_rng(SEED + 16)

        def piece(n, g=None):
            """A slice of n bp of the genome with about one base in 30
            changed, so reads score high against refs cut from it (drawn
            from ``g``, by default the script's generator)."""
            g = rng if g is None else g
            o = int(g.integers(0, len(genome) - int(n) + 1))
            arr = np.frombuffer(genome[o : o + int(n)].encode(), np.uint8).copy()
            hit = g.random(arr.size) < 1 / 30
            arr[hit] = np.frombuffer(b"ACGT", np.uint8)[g.integers(0, 4, int(hit.sum()))]
            return arr.tobytes().decode()

        def lay(rows, m):
            """Packed rows of m lanes with the reads of each row laid left to
            right (START_BIT on each read's first lane and on the first
            trailing pad lane), padded to 8 rows; the reads in lane order
            and their start lanes."""
            packed = np.full((-(-len(rows) // 8) * 8, m), READ_PAD, np.int32)
            packed[:, 0] |= 256
            order, start = [], []
            for r, reads in enumerate(rows):
                o = 0
                for read in reads:
                    packed[r, o : o + len(read)] = encode_batch([read], len(read), READ_PAD)[0]
                    packed[r, o] |= 256
                    order.append(read)
                    start.append(r * m + o)
                    o += len(read)
                if o < m:
                    packed[r, o] |= 256
            return packed, order, np.array(start, np.int64)

        def wide_rows(m):
            """Rows of m lanes: one read over every stripe; reads starting on
            the stripe boundaries 512 and 1,024; a 2 bp read across 512 and
            one across 256 (the s16x2 form's stripes); reads of 1-1,500 bp
            across boundaries at random; a pad row."""
            def filled(reads):
                o = sum(map(len, reads))
                while o < m - 40:
                    reads.append(piece(min(int(rng.integers(1, 1501)), m - o)))
                    o += len(reads[-1])
                return reads
            return [[piece(m)], filled([piece(512), piece(512), piece(1)]), filled([piece(511), piece(2)]),
                    filled([piece(255), piece(2)]), filled([]), filled([piece(1)]), []]

        def chain_k3(packed_t, start_t, refs, segs, bnd_rng=None, longest=None):
            """K3 over ``segs`` segments of every ref, each bnd_out into the
            next from a zero left column (or, with bnd_rng, each segment
            from a random left column and held against the plain version,
            and, where k3_form gives s16x2, against the int32 form), the
            pack's longest read given as ``longest``, each call in k3_form's
            form: (the max of the start lanes over segments, max abs err
            against plain)."""
            flat, lens = encode_concat(refs)
            offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
            ns = np.maximum(1, -(-lens // segs)).astype(np.int32)
            bnd = torch.zeros((len(refs),) + tuple(packed_t.shape), dtype=torch.int32, device=dev)
            best, err = None, 0
            for k in range(segs):
                seg_lens = np.clip(lens - k * ns, 0, ns).astype(np.int32)
                seg_offs = np.where(seg_lens > 0, offsets + k * ns, 0).astype(np.int64)
                if bnd_rng is not None:
                    bnd = up(bnd_rng.integers(0, 120, size=tuple(bnd.shape)).astype(np.int32))
                args = (packed_t, up(flat), up(seg_offs), up(seg_lens), up(ns), bnd, *PARAMS)
                form = cuda_score.k3_form(packed_t.shape[1], *PARAMS, longest=longest)
                lane, bnd_next = formed("K3", lambda: cuda_score.band_lane_best(*args, longest=longest), form)
                if bnd_rng is not None:
                    pl, pb = cuda_score.band_lane_best_plain(*args)
                    err = max(err, max_err(lane.reshape(len(refs), -1)[:, start_t], pl.reshape(len(refs), -1)[:, start_t]),
                              max_err(bnd_next, pb))
                    if form == "s16x2":
                        held_to_int32("K3", packed_t.shape[1], k3_lanes(lane, bnd_next, start_t),
                                      lambda: k3_lanes(*cuda_score._band_lane_best(*args, longest=longest, form="int32"),
                                                       start_t))
                got = lane.reshape(len(refs), -1)[:, start_t]
                best = got if best is None else torch.maximum(best, got)
                bnd = bnd_next
            return best, err

        widths = (1025, 2048, 4096, 16384)
        wide_err = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
        # K1's, K2's, K3's, K4's, K5's and K8's s16x2 wide form against the
        # int32 one: max abs err (K2 on the traceback's lanes, K3 on the
        # start and bnd_out lanes), and the widths at which it was held to it.
        s16_vs_int32 = {k: [0, []] for k in ("K1", "K2", "K3", "K4", "K5", "K8")}

        def k3_lanes(lane, bnd_out, start_t):
            """K3's start lanes and bnd_out lanes, flat."""
            return torch.cat([lane.reshape(lane.shape[0], -1)[:, start_t].reshape(-1), bnd_out.reshape(-1)])

        def formed(k, fn, want_form):
            """fn()'s result, failing unless its launches of kernel k (K1-K5,
            K8) all took want_form (k1k4_form's, k3_form's or k5_form's)."""
            counts = getattr(cuda_score, f"{k}_FORMS")
            before = dict(counts)
            out = fn()
            took = {form: n - before[form] for form, n in counts.items() if n != before[form]}
            fail_unless(list(took) == [want_form], f"{k} took {took} where its rule says {want_form}")
            return out

        def held_to_int32(k, m, got, int32_fn):
            want = int32_fn()
            err = consumed_err(got, want, f"{m} lanes, int32") if k == "K2" else max_err(got, want)
            s16_vs_int32[k][0] = max(s16_vs_int32[k][0], err)
            s16_vs_int32[k][1].append(m)
            fail_unless(s16_vs_int32[k][0] == 0, f"{k}'s s16x2 striped form differs from its int32 form at {m} lanes")

        refs_w = [piece(1500), piece(600), piece(1)]
        flat_w, lens_w = encode_concat(refs_w)
        offs_w = up(np.concatenate(([0], np.cumsum(lens_w)[:-1])).astype(np.int64))
        flat_w, lens_w_t = up(flat_w), up(lens_w.astype(np.int32))

        def k1_w_args(p_t):
            return p_t, flat_w, lens_w_t

        for m in widths:
            rows_m = wide_rows(m)
            packed, order, start = lay(rows_m, m)
            packed_t, start_t = up(packed), up(start)
            k1_form_m = cuda_score.k1k4_form(m, *PARAMS)
            k1_w = formed("K1", lambda: read_best(cuda_score.lane_best_packed_varlen(*k1_w_args(packed_t), *PARAMS,
                                                                                     offsets=offs_w), start), k1_form_m)
            p1_w = read_best(cuda_score.lane_best_packed_varlen_plain(packed_t, flat_w, lens_w_t, *PARAMS, offs_w), start)
            wide_err["K1"] = max(wide_err["K1"], max_err(k1_w, p1_w))
            if k1_form_m == "s16x2":
                held_to_int32("K1", m, k1_w, lambda: read_best(cuda_score._lane_best_packed_varlen(
                    *k1_w_args(packed_t), *PARAMS, offsets=offs_w, form="int32"), start))
            _, err = chain_k3(packed_t, start_t, refs_w, 1, bnd_rng=rng)
            wide_err["K3"] = max(wide_err["K3"], err)
            for segs in (2, 4):
                fail_unless(torch.equal(chain_k3(packed_t, start_t, refs_w, segs)[0], k1_w.T),
                            f"{segs} chained K3 segments differ from K1 at {m} lanes")
            if m == 4096:
                # K3's 16-bit form at 4,096 lanes: reads of at most 3,276 bp,
                # the longest given (k3_form: 5 x 6,551 <= 32,767).
                packed_k3, _, start_k3 = lay([[piece(3276, k38_rng), piece(m - 3276, k38_rng)]] + rows_m[1:], m)
                pk3_t, sk3_t = up(packed_k3), up(start_k3)
                _, err = chain_k3(pk3_t, sk3_t, refs_w, 1, bnd_rng=k38_rng, longest=3276)
                wide_err["K3"] = max(wide_err["K3"], err)
                k1_k3 = read_best(cuda_score.lane_best_packed_varlen(*k1_w_args(pk3_t), *PARAMS, offsets=offs_w,
                                                                     longest=3276), start_k3)
                for segs in (2, 4):
                    fail_unless(torch.equal(chain_k3(pk3_t, sk3_t, refs_w, segs, longest=3276)[0], k1_k3.T),
                                f"{segs} chained K3 segments (s16x2, longest 3,276) differ from K1 at {m} lanes")
            reads_g = [piece(m), piece(m - 1), piece(600), piece(1), piece(513), piece(min(m, 1100)), piece(m - 512), ""]
            args_2w = k2_grid(reads_g, refs_w[0])
            k2_form_m = cuda_score.k1k4_form(args_2w[0].shape[1], *PARAMS)
            got = formed("K2", lambda: cuda_score.argmax_lane(*args_2w, *PARAMS), k2_form_m)
            want = cuda_score.argmax_lane_plain(*args_2w, *PARAMS)
            if k2_form_m == "s16x2":  # every lane, pad rows and the columns right of the reference too
                err = max(max_err(a, b) for a, b in zip(got, want))
                held_to_int32("K2", m, got, lambda: cuda_score._argmax_lane(*args_2w, *PARAMS, form="int32"))
            else:
                err = consumed_err(got, want, f"{m} lanes")
            wide_err["K2"] = max(wide_err["K2"], err)
            args_g = grid_args(reads_g, refs_w, m)
            want_g = cuda_score.score_grid_diag_plain(*args_g, *PARAMS)
            k4_form_m = cuda_score.k1k4_form(m, *PARAMS)
            got_g = formed("K4", lambda: cuda_score.score_grid_diag(*args_g, *PARAMS), k4_form_m)
            wide_err["K4"] = max(wide_err["K4"], max_err(got_g, want_g))
            if k4_form_m == "s16x2":
                held_to_int32("K4", m, got_g, lambda: cuda_score._score_grid_diag(*args_g, *PARAMS, form="int32"))
            if m == 16384:
                # 16,384 lanes in s16x2: K1 on rows of reads of at most 6,553
                # bp (its longest given) against plain and the int32 form; K1
                # and K4 at match 1 (1 x 16,384 fits int16), K4 against plain
                # and K1 against the int32 form (its plain version at this
                # width is the slow part of the phase).
                packed_16, _, start_16 = lay([[piece(6553), piece(6553), piece(3278)], [piece(5000), piece(511)],
                                              [piece(1), piece(6000)]], m)
                p16_t = up(packed_16)
                got = formed("K1", lambda: read_best(cuda_score.lane_best_packed_varlen(
                    *k1_w_args(p16_t), *PARAMS, offsets=offs_w, longest=6553), start_16), "s16x2")
                wide_err["K1"] = max(wide_err["K1"], max_err(got, read_best(
                    cuda_score.lane_best_packed_varlen_plain(*k1_w_args(p16_t), *PARAMS, offs_w), start_16)))
                held_to_int32("K1", m, got, lambda: read_best(cuda_score._lane_best_packed_varlen(
                    *k1_w_args(p16_t), *PARAMS, offsets=offs_w, form="int32"), start_16))
                params_1 = (1, -3, -4)
                got = formed("K1", lambda: read_best(cuda_score.lane_best_packed_varlen(
                    *k1_w_args(packed_t), *params_1, offsets=offs_w), start), "s16x2")
                held_to_int32("K1", m, got, lambda: read_best(cuda_score._lane_best_packed_varlen(
                    *k1_w_args(packed_t), *params_1, offsets=offs_w, form="int32"), start))
                got = formed("K4", lambda: cuda_score.score_grid_diag(*args_g, *params_1), "s16x2")
                want_1 = cuda_score.score_grid_diag_plain(*args_g, *params_1)
                wide_err["K4"] = max(wide_err["K4"], max_err(got, want_1))
                held_to_int32("K4", m, got, lambda: cuda_score._score_grid_diag(*args_g, *params_1, form="int32"))
                # K5 at match 1 against K4's plain version (K5's contract is
                # K4's) and its int32 form; K2 against its int32 form.
                got = formed("K5", lambda: cuda_score.score_grid_row(*args_g, *params_1), "s16x2")
                wide_err["K5"] = max(wide_err["K5"], max_err(got, want_1))
                held_to_int32("K5", m, got, lambda: cuda_score._score_grid_row(*args_g, *params_1, form="int32"))
                got = formed("K2", lambda: cuda_score.argmax_lane(*args_2w, *params_1), "s16x2")
                held_to_int32("K2", m, got, lambda: cuda_score._argmax_lane(*args_2w, *params_1, form="int32"))
            k5_form_m = cuda_score.k5_form(m, *PARAMS)
            got = formed("K5", lambda: cuda_score.score_grid_row(*args_g, *PARAMS), k5_form_m)
            wide_err["K5"] = max(wide_err["K5"], max_err(got, want_g))
            if k5_form_m == "s16x2":
                held_to_int32("K5", m, got, lambda: cuda_score._score_grid_row(*args_g, *PARAMS, form="int32"))
            fail_unless(not any(wide_err.values()), f"a striped kernel differs from its plain version at {m} lanes: {wide_err}")
            if m <= 4096 or m == 16384:  # K8's wide form on the same reads (to 8,000 bp) and a repeat
                m8 = min(m, 8000)
                args_8w = up(encode_batch([r[:m8] for r in reads_g[:-1]] + [("ACGT" * m8)[: m8 - 3]], m8, READ_PAD))
                best_8w = score_grid(args_8w, args_2w[1], *PARAMS)[:, 0].to(torch.int32).contiguous()
                want_8w, _ = k8_check(f"{m8} lanes", args_8w, args_2w[1][0], best_8w, 1024)
                if cuda_score.k5_form(m8, *PARAMS) == "s16x2":  # K8's wide s16x2 form held to int32 too
                    k8_check(f"{m8} lanes, int32", args_8w, args_2w[1][0], best_8w, 1024, want_8w, form="int32")
                    k8_check(f"{m8} lanes, one segment", args_8w, args_2w[1][0], best_8w, 1024, want_8w,
                             split=False)
                    s16_vs_int32["K8"][1].append(m8)
            if m == 2048:
                # Again with a carry budget of 1: each launch then runs in
                # parts of one block of four rows (reads), sharing one scratch.
                # Its own generator leaves the later phases' inputs as they were.
                split_rng = np.random.default_rng(SEED + 14)
                bnd_w = up(split_rng.integers(0, 120, size=(len(refs_w),) + packed.shape).astype(np.int32))
                # Three times the rows (reads), so that the s16x2 forms' blocks
                # of eight rows (four pairs) also split.
                packed_3 = up(lay(rows_m * 3, m)[0])
                bnd_w3 = up(split_rng.integers(0, 120, size=(len(refs_w),) + tuple(packed_3.shape)).astype(np.int32))
                args_g3 = grid_args(reads_g * 3, refs_w, m)
                calls = {
                    "K1": lambda: cuda_score.lane_best_packed_varlen(packed_t, flat_w, lens_w_t, *PARAMS, offsets=offs_w),
                    "K1 (24 rows)": lambda: cuda_score.lane_best_packed_varlen(*k1_w_args(packed_3), *PARAMS,
                                                                               offsets=offs_w),
                    "K1 int32 (24 rows)": lambda: cuda_score._lane_best_packed_varlen(*k1_w_args(packed_3), *PARAMS,
                                                                                      offsets=offs_w, form="int32"),
                    "K4 (24 reads)": lambda: cuda_score.score_grid_diag(*args_g3, *PARAMS),
                    "K4 int32 (24 reads)": lambda: cuda_score._score_grid_diag(*args_g3, *PARAMS, form="int32"),
                    "K3": lambda: cuda_score.band_lane_best(packed_t, flat_w, offs_w, lens_w_t, lens_w_t.clamp_min(1),
                                                            bnd_w, *PARAMS),
                    "K3 (24 rows)": lambda: cuda_score.band_lane_best(packed_3, flat_w, offs_w, lens_w_t,
                                                                      lens_w_t.clamp_min(1), bnd_w3, *PARAMS),
                    "K3 int32 (24 rows)": lambda: cuda_score._band_lane_best(packed_3, flat_w, offs_w, lens_w_t,
                                                                             lens_w_t.clamp_min(1), bnd_w3, *PARAMS,
                                                                             form="int32"),
                    "K8": lambda: cuda_score.max_cells_row(args_8w, args_2w[1][0], best_8w, *PARAMS, 1024),
                    "K8 int32": lambda: cuda_score._max_cells_row(args_8w, args_2w[1][0], best_8w, *PARAMS, 1024,
                                                                  form="int32"),
                    "K2": lambda: cuda_score.argmax_lane(*args_2w, *PARAMS),
                    "K2 int32": lambda: cuda_score._argmax_lane(*args_2w, *PARAMS, form="int32"),
                    "K4": lambda: cuda_score.score_grid_diag(*args_g, *PARAMS),
                    "K5 (24 reads)": lambda: cuda_score.score_grid_row(*args_g3, *PARAMS),
                    "K5 int32 (24 reads)": lambda: cuda_score._score_grid_row(*args_g3, *PARAMS, form="int32"),
                }
                whole = {k: fn() for k, fn in calls.items()}
                budget, cuda_score.CARRY_BUDGET = cuda_score.CARRY_BUDGET, 1
                try:
                    split = {k: fn() for k, fn in calls.items()}
                finally:
                    cuda_score.CARRY_BUDGET = budget
                for k in calls:
                    a, b = whole[k], split[k]
                    fail_unless(all(torch.equal(x, y) for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,))))),
                                f"{k} with its rows split over launches differs from one launch at {m} lanes")
                split_parts = (packed.shape[0] // 4, len(reads_g) // 4, 3 * packed.shape[0] // 8, 3 * len(reads_g) // 8,
                               len(reads_g) // 2)
        print(f"[14] K1-K5 at rows (reads) of {', '.join(map(str, widths))} lanes, stripes of {cuda_score.STRIPE_LANES} "
              f"(s16x2: {cuda_score.STRIPE16_LANES}): "
              f"max abs err {wide_err} against the plain versions (K1, K3 at every start lane, K3 at every bnd_out lane "
              f"with a random left column; K2 in s16x2 on every lane, in int32 on the traceback's lanes; K4, K5 every "
              f"pair, K5 against K4's plain version, its contract); every K1, K2 and K4 "
              f"call in k1k4_form's form, every K3 call in k3_form's and every K5 and K8 call in k5_form's, the s16x2 "
              f"wide form equal to the int32 one (max abs err, K2 on the traceback's lanes, K3 on the start and "
              f"bnd_out lanes, K8 both forms equal to plain: "
              + ", ".join(f"{k} {e} at {w}" for k, (e, w) in s16_vs_int32.items())
              + f"; at 16,384 K1 on reads of at most 6,553 bp and K1, K2, K4 and K5 at match 1; at 4,096 K3 on "
              f"reads of at most 3,276 bp, the longest given); reads over every "
              f"stripe, starting on stripe boundaries and crossing them; K3 "
              f"chained over 2 and 4 segments equal to K1 at every width (at 4,096 in both forms); K8 equal to plain "
              f"at 1,025-8,000 lanes (s16x2 to 4,096, also as one segment; int32 at 8,000); at 2,048 lanes with a "
              f"carry budget of 1 (K1 and K3 s16x2 and int32 on 24 rows in "
              f"{split_parts[2]} launches of 8 and {2 * split_parts[2]} of 4, K4 and K5 on 24 reads likewise in "
              f"{split_parts[3]} and {2 * split_parts[3]}, K3 on 8 rows in {split_parts[0] // 2} launch, K2 in "
              f"{split_parts[4]} launches of a pair and int32 in {split_parts[1]} of 4 reads, K8 in one launch of 8 "
              f"reads and int32 in two of 4) equal to one launch on every lane ({time.perf_counter() - t14:.1f} s)",
              flush=True)

        # K2's striped s16x2 form in column segments: reads of 1,025 and
        # 2,048 positions against 20 kb and 40 kb of the genome, which
        # argmax_segments cuts (the references above are too short to); every lane against
        # plain and the traceback's lanes against the int32 form, at the
        # default carry budget and at a budget of 1 (a pair a launch).
        # Its own generator leaves the later phases' inputs as they were.
        cut_rng = np.random.default_rng(SEED + 15)
        k2_cut = {}
        for m in (1025, 2048):
            # 1,025 positions split against the genome's first 20 kb already
            # (the plain version's diagonals are most of this check's time).
            ref_s = genome if m == 2048 else genome[:20_000]
            reads_s = [piece(m, cut_rng), piece(m - 1, cut_rng), ref_s[-(m - 3):], ref_s[:700], piece(600, cut_rng),
                       piece(513, cut_rng), piece(1, cut_rng), ""]
            args_s = k2_grid(reads_s, ref_s)
            plan_s = cuda_score.argmax_segments(args_s[0].shape[1], len(ref_s), *PARAMS, -(-len(reads_s) // 2), sms)
            fail_unless(plan_s[3] > 1, f"K2 at {m} positions against {len(ref_s)} bp does not split: {plan_s}")
            want_s = cuda_score.argmax_lane_plain(*args_s, *PARAMS)
            int32_s = cuda_score._argmax_lane(*args_s, *PARAMS, form="int32")
            for budget in (cuda_score.CARRY_BUDGET, 1):
                saved, cuda_score.CARRY_BUDGET = cuda_score.CARRY_BUDGET, budget
                try:
                    got = formed("K2", lambda: cuda_score.argmax_lane(*args_s, *PARAMS), "s16x2")
                finally:
                    cuda_score.CARRY_BUDGET = saved
                err = max(max_err(a, b) for a, b in zip(got, want_s))
                wide_err["K2"] = max(wide_err["K2"], err)
                fail_unless(err == 0, f"K2 in segments at {m} positions (carry budget {budget}) differs from plain "
                                      f"({err})")
                held_to_int32("K2", m, got, lambda: int32_s)
            k2_cut[m] = plan_s[3], len(ref_s)
        print(f"[14] K2 s16x2 striped in column segments against the genome: "
              + ", ".join(f"{m} positions x {n} bp in {k} segments" for m, (k, n) in k2_cut.items())
              + f", 8 reads each (one of the reference's last bp), equal to plain on every lane and to the int32 form "
              f"on the traceback's lanes, at the default carry budget and at 1", flush=True)

        # K3's and K8's wide forms cut into column pieces (segments), each
        # plan checked to cut: K3 on rows of 2,048 lanes (and of 4,096,
        # reads of at most 3,000 bp, the longest given) x one segment of the
        # 40 kb genome and 5 kb more, a random left column, every start lane
        # and bnd_out lane; K8 on two tied reads of 2,048 positions (A, C and
        # G) planted in a LONG_N ref of Ts around the borders of the columns
        # its segments own.  Each against the same form as one piece and the
        # int32 form (both held to plain above), cut and whole.
        cut38 = {}
        ref_45 = genome + piece(5000, k38_rng)
        flat_45, lens_45 = encode_concat([ref_45])
        for m, longest in ((2048, None), (4096, 3000)):
            top = longest or m
            packed_c, _, start_c = lay([[piece(top, k38_rng)], [piece(700, k38_rng), piece(900, k38_rng)],
                                        [piece(1000, k38_rng), piece(1040, k38_rng)]], m)
            args_c = (up(packed_c), up(flat_45), up(np.zeros(1, np.int64)), up(lens_45.astype(np.int32)),
                      up(lens_45.astype(np.int32)),
                      up(k38_rng.integers(0, 120, size=(1,) + packed_c.shape).astype(np.int32)), *PARAMS)
            plan_c = cuda_score.band_segments(m, len(ref_45), 1, -(-packed_c.shape[0] // 8), *PARAMS, sms,
                                              longest=longest)
            fail_unless(plan_c[0] < len(ref_45), f"K3 does not cut {m}-lane rows x {len(ref_45)} bp: {plan_c}")
            outs = {(form, split): k3_lanes(*cuda_score._band_lane_best(*args_c, longest=longest, form=form,
                                                                         split=split), up(start_c))
                    for form in ("s16x2", "int32") for split in (True, False)}
            err = max(max_err(o, outs["int32", False]) for o in outs.values())
            s16_vs_int32["K3"][0] = max(s16_vs_int32["K3"][0], err)
            fail_unless(err == 0, f"K3 in pieces at {m} lanes differs from one piece or from int32 ({err})")
            cut38["K3", m] = len(cuda_score.band_pieces(len(ref_45), *plan_c))
        reads_c = ["".join(k38_rng.choice(list("ACG"), size=2048)) for _ in range(2)]
        stride_c, length_c, skip_c = cuda_score.max_cells_segments(2048, LONG_N, *PARAMS, 1, sms)
        fail_unless(stride_c < LONG_N, f"K8 does not cut 2 reads of 2,048 x {LONG_N} bp: {(stride_c, skip_c)}")
        ends_c = [[10 * stride_c + skip_c - 1, 10 * stride_c + skip_c + 4101, 40 * stride_c + skip_c, LONG_N - 1],
                  [60 * stride_c + skip_c + 1, 110_000]]
        ref_c = bytearray(b"T" * LONG_N)
        for read, ends in zip(reads_c, ends_c):
            for end in ends:
                ref_c[end - 2047 : end + 1] = read.encode()
        args_8c = (up(encode_batch(reads_c, 2048, READ_PAD)), up(encode_batch([ref_c.decode()], LONG_N, REF_PAD)[0]),
                   up(np.full(2, 5 * 2048, np.int32)), *PARAMS, 64)
        outs = {(form, split): cuda_score._max_cells_row(*args_8c, form=form, split=split)
                for form in ("s16x2", "int32") for split in (True, False)}
        want_c = outs["int32", False]
        fail_unless(want_c[0].tolist() == [4, 2] and want_c[1][0, :4, 1].tolist() == sorted(ends_c[0])
                    and want_c[1][1, :2, 1].tolist() == sorted(ends_c[1]),
                    f"the ties planted for K8 are not its int32 listing's: {want_c[0].tolist()}")
        fail_unless(all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, want_c)),
                    "K8 in segments at 2,048 positions differs from one segment or from int32")
        cut38["K8", 2048] = -(-LONG_N // stride_c)
        print(f"[14] K3 and K8 wide in column pieces: K3 at 2,048 and 4,096 lanes (reads of at most 3,000 bp) x "
              f"{len(ref_45)} bp in {cut38['K3', 2048]} and {cut38['K3', 4096]} pieces, s16x2 and int32, cut and "
              f"whole, equal at every start lane and bnd_out lane; K8 two reads of 2,048 positions x {LONG_N} bp in "
              f"{cut38['K8', 2048]} segments (stride {stride_c}, skip {skip_c}), ties planted at columns "
              f"{ends_c} listed once each, s16x2 and int32, cut and whole, equal", flush=True)

        long_ref = genome + rand_seqs(rng, [LONG_N - len(genome)])[0]
        packed, order, start = lay([[piece(2048)], [piece(1000), piece(1048)], [piece(700), piece(900), piece(300)]], 2048)
        got = read_best(cuda_score.lane_best_packed(up(packed), up(encode_batch([long_ref], LONG_N, REF_PAD)), *PARAMS), start)
        want = score_grid(up(encode_batch(order, 2048, READ_PAD)), up(encode_batch([long_ref], LONG_N, REF_PAD)), *PARAMS)
        err = max_err(got, want)
        fail_unless(err == 0, f"K1 at 2,048 lanes against a {LONG_N} bp ref differs from the row-form recurrence ({err})")
        wide_err["K1"] = max(wide_err["K1"], err)
        print(f"[14] K1, 2,048-lane rows (6 reads) against one {LONG_N} bp ref: equal to the row-form recurrence, "
              f"best {int(want.max())}", flush=True)

        # Times at 4,096 lanes.
        refs_t = [piece(n) for n in rng.integers(500, 4001, 64)]
        flat_t, lens_t = encode_concat(refs_t)
        order_t = np.argsort(-lens_t, kind="stable")
        offs_t = np.concatenate(([0], np.cumsum(lens_t)[:-1])).astype(np.int64)
        k1_t = (up(flat_t), up(lens_t[order_t].astype(np.int32)), up(offs_t[order_t]))
        reads_t = [piece(n) for n in rng.integers(500, 4097, 64)]
        packed_t4, start_t4 = pack_reads(reads_t, 4096)
        packed_t4 = up(packed_t4)
        ref_bp = int(lens_t.sum())
        wide_t = {}
        wide_int32_ms = {}  # each kernel's int32 wide form at 4,096 lanes, beside wide_t's s16x2

        def turns_wide(name, fn, rows, cells, nbytes, lanes=lambda out: out, blocks=None):
            """A kernel's two striped forms at 4,096 lanes, fn(form), in
            turns by events (in_turns: int32, s16x2, s16x2, int32, 3 calls
            each, as [1] and [8] time the one-pass forms): each form's mean
            ms, the bound and the blocks per SM; the lanes a caller reads
            (``lanes``) equal in both forms, and the s16x2 form must be the
            faster."""
            turns, outs = in_turns(fn, 3)
            fail_unless(torch.equal(lanes(outs["s16x2"]), lanes(outs["int32"])),
                        f"{name}'s two striped forms differ at 4,096 lanes")
            ms = {form: float(np.mean(turns[form])) for form in turns}
            wide_t[name] = (ms["s16x2"], *bound(cells, nbytes, sms, clock_mhz))
            wide_int32_ms[name] = ms["int32"]
            blocks = {form: n / sms for form, n in (blocks or {
                form: -(-rows // (per * 4)) * 64 for form, per in (("s16x2", 2), ("int32", 1))}).items()}
            print(f"[14] {name} at 4,096 lanes, both striped forms in turns (events): int32, s16x2, s16x2, int32 "
                  + ", ".join(f"{t:.3f}" for t in (turns["int32"][0], *turns["s16x2"], turns["int32"][1]))
                  + f" ms ({blocks['s16x2']:.2f} and {blocks['int32']:.2f} blocks an SM), "
                  f"{ms['int32'] / ms['s16x2']:.2f}x; bound {wide_t[name][1]:.3f} ms by {wide_t[name][2]} = "
                  f"{100 * wide_t[name][1] / ms['s16x2']:.1f}% (int32 {100 * wide_t[name][1] / ms['int32']:.1f}%); "
                  f"{cells / ms['s16x2'] / 1e6:.1f} GCUPS real cells", flush=True)
            fail_unless(max(turns["s16x2"]) < min(turns["int32"]),
                        f"{name}'s s16x2 striped form ({turns['s16x2']} ms) is not faster than its int32 form "
                        f"({turns['int32']} ms) at 4,096 lanes")

        out_bytes = 64 * packed_t4.numel() * 4
        turns_wide("K1", lambda form: cuda_score._lane_best_packed_varlen(packed_t4, k1_t[0], k1_t[1], *PARAMS,
                                                                          offsets=k1_t[2], form=form),
                   packed_t4.shape[0], sum(map(len, reads_t)) * ref_bp,
                   packed_t4.numel() * 4 + ref_bp + 64 * 12 + out_bytes, lambda out: read_best(out, start_t4))
        # K3 on 64 reads of 500-3,276 bp (the longest given, so that its rule
        # admits 4,096-lane rows) x the 64 refs, a random left column.
        reads_3t = [piece(n, k38_rng) for n in k38_rng.integers(500, 3277, 64)]
        packed_3t, start_3t = pack_reads(reads_3t, 4096)
        packed_3t, start_3t = up(packed_3t), up(start_3t.astype(np.int64))
        bnd_3t = up(k38_rng.integers(0, 120, size=(64,) + tuple(packed_3t.shape)).astype(np.int32))
        out_3t = 64 * packed_3t.numel() * 4
        turns_wide("K3", lambda form: cuda_score._band_lane_best(packed_3t, k1_t[0], k1_t[2], k1_t[1], k1_t[1], bnd_3t,
                                                                 *PARAMS, carry_cols=ref_bp, longest=3276, form=form),
                   packed_3t.shape[0], sum(map(len, reads_3t)) * ref_bp,
                   packed_3t.numel() * 4 + ref_bp + 64 * 16 + 3 * out_3t, lambda out: k3_lanes(*out, start_3t))
        args_t = grid_args(reads_t, refs_t, 4096)
        grid_bytes = sum(t.numel() for t in args_t) + 4 * 64 * 64
        turns_wide("K4", lambda form: cuda_score._score_grid_diag(*args_t, *PARAMS, form=form),
                   args_t[0].shape[0], sum(map(len, reads_t)) * ref_bp, grid_bytes)
        turns_wide("K5", lambda form: cuda_score._score_grid_row(*args_t, *PARAMS, form=form),
                   args_t[0].shape[0], sum(map(len, reads_t)) * ref_bp, grid_bytes)
        reads_2t = reads_t + [piece(n) for n in rng.integers(500, 4097, 64)]
        args_2t = (up(encode_batch(reads_2t, 4096, READ_PAD)), up(encode_batch([refs_t[0]], len(refs_t[0]), REF_PAD)))

        def k2_lanes(out):
            """The lanes the traceback reads (best = the read's max) and
            K2's three values there."""
            cons = out[0] == out[0].amax(dim=2, keepdim=True)
            return torch.stack([cons.to(torch.int32), *(torch.where(cons, x, 0) for x in out)])

        # K2's s16x2 wide blocks are a pair of reads each (its warps on four
        # stripes at once), the int32 ones four reads.
        turns_wide("K2", lambda form: cuda_score._argmax_lane(*args_2t, *PARAMS, form=form), len(reads_2t),
                   sum(map(len, reads_2t)) * len(refs_t[0]), args_2t[0].numel() + args_2t[1].numel()
                   + 3 * 4 * args_2t[0].numel(), k2_lanes, {"s16x2": len(reads_2t) // 2, "int32": len(reads_2t) // 4})
        # K8's two wide forms on the same reads, at their bests (the
        # row-form recurrence), capacity 64: inputs, the count and the slots.
        best_8t = score_grid(*args_2t, *PARAMS)[:, 0].to(torch.int32).contiguous()
        segs_8t = -(-len(refs_t[0]) // cuda_score.max_cells_segments(4096, len(refs_t[0]), *PARAMS, 64, sms)[0])
        turns_wide("K8", lambda form: cuda_score._max_cells_row(args_2t[0], args_2t[1][0], best_8t, *PARAMS, 64,
                                                                form=form),
                   len(reads_2t), sum(map(len, reads_2t)) * len(refs_t[0]),
                   args_2t[0].numel() + args_2t[1].numel() + 4 * 128 + 128 * (8 + 64 * 2 * 4),
                   lambda out: torch.cat([out[0], out[1].reshape(-1).to(torch.int64)]),
                   {"s16x2": len(reads_2t) // 2 * segs_8t, "int32": len(reads_2t) // 4 * segs_8t})

        # The cliffs: each cut against the same form whole (s16x2), events,
        # outputs equal.  K3: 256 reads of 80-150 bp and one of 2,000 bp in
        # rows of 2,048 lanes (as band_prepack packs them) x one 1 Mb
        # segment; K8: one tied 2,048 bp read x a 131,072 bp ref holding it
        # twice.
        reads_3l = [piece(n, k38_rng) for n in k38_rng.integers(80, 151, 256)] + [piece(2000, k38_rng)]
        packed_3l, start_3l = pack_reads(reads_3l, 2048)
        packed_3l, start_3l = up(packed_3l), up(start_3l.astype(np.int64))
        flat_3l = up(encode_concat(rand_seqs(k38_rng, [1_000_000]))[0])
        n_3l = up(np.array([1_000_000], np.int32))
        args_3l = (packed_3l, flat_3l, up(np.zeros(1, np.int64)), n_3l, n_3l,
                   torch.zeros((1,) + tuple(packed_3l.shape), dtype=torch.int32, device=dev), *PARAMS)
        plan_3l = cuda_score.band_segments(2048, 1_000_000, 1, -(-packed_3l.shape[0] // 8), *PARAMS, sms, longest=2000)
        fail_unless(plan_3l[0] < 1_000_000, f"K3 does not cut the 1 Mb segment: {plan_3l}")
        cut_3l = k3_lanes(*cuda_score.band_lane_best(*args_3l, carry_cols=1_000_000, longest=2000), start_3l)
        # One piece takes about half a second: one call, timed by events, gives its output too.
        events_3l = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events_3l[0].record()
        whole_3l = cuda_score._band_lane_best(*args_3l, carry_cols=1_000_000, longest=2000, split=False)
        events_3l[1].record()
        torch.cuda.synchronize()
        fail_unless(torch.equal(cut_3l, k3_lanes(*whole_3l, start_3l)),
                    "K3 on the 1 Mb segment in pieces differs from one piece")
        pieces_3l = len(cuda_score.band_pieces(1_000_000, *plan_3l))
        rb_3l = -(-packed_3l.shape[0] // 8)
        long_t = {"K3": (cuda_ms(lambda: cuda_score.band_lane_best(*args_3l, carry_cols=1_000_000, longest=2000), 3),
                         events_3l[0].elapsed_time(events_3l[1]),
                         *bound(sum(map(len, reads_3l)) * 1_000_000,
                                packed_3l.numel() * 4 + 1_000_000 + 3 * packed_3l.numel() * 4, sms, clock_mhz),
                         rb_3l * pieces_3l / sms, rb_3l / sms)}
        read_8l = "".join(k38_rng.choice(list("ACGT"), size=2048))
        ref_8l = rand_seqs(k38_rng, [LONG_N])[0]
        ref_8l = ref_8l[:20_000] + read_8l + ref_8l[22_048:90_000] + read_8l + ref_8l[92_048:]
        args_8l = (up(encode_batch([read_8l], 2048, READ_PAD)), up(encode_batch([ref_8l], LONG_N, REF_PAD)))
        best_8l = up(np.array([5 * 2048], np.int32))  # its two copies
        cut_8l = cuda_score.max_cells_row(args_8l[0], args_8l[1][0], best_8l, *PARAMS, 64)
        whole_8l = cuda_score._max_cells_row(args_8l[0], args_8l[1][0], best_8l, *PARAMS, 64, split=False)
        fail_unless(int(cut_8l[0][0]) == 2 and all(torch.equal(a, b) for a, b in zip(cut_8l, whole_8l)),
                    f"K8 on the tied 2,048 bp read x {LONG_N} bp in segments differs from one segment "
                    f"({cut_8l[0].tolist()}, {whole_8l[0].tolist()})")
        segs_8l = -(-LONG_N // cuda_score.max_cells_segments(2048, LONG_N, *PARAMS, 1, sms)[0])
        long_t["K8"] = (cuda_ms(lambda: cuda_score.max_cells_row(args_8l[0], args_8l[1][0], best_8l, *PARAMS, 64), 3),
                        cuda_ms(lambda: cuda_score._max_cells_row(args_8l[0], args_8l[1][0], best_8l, *PARAMS, 64,
                                                                  split=False), 1),
                        *bound(2048 * LONG_N, 2048 + LONG_N + 4 + 8 + 64 * 8, sms, clock_mhz), segs_8l / sms, 1 / sms)
        shapes = {"K3": f"{packed_3l.shape[0]} rows of 2,048 lanes x 1 Mb in {pieces_3l} pieces",
                  "K8": f"one tied 2,048 bp read x {LONG_N} bp in {segs_8l} segments"}
        for k, (cut_ms, whole_ms, bound_ms, bound_by, cut_bps, whole_bps) in long_t.items():
            print(f"[14] {k} wide s16x2 on its long-reference shape ({shapes[k]}): cut {cut_ms:.3f} ms ({cut_bps:.2f} blocks an SM), whole {whole_ms:.3f} ms ({whole_bps:.2f}), "
                  f"{whole_ms / cut_ms:.1f}x, outputs equal; bound {bound_ms:.3f} ms by {bound_by} = "
                  f"{100 * bound_ms / cut_ms:.1f}% of the cut's time", flush=True)

        print(f"[14] {k1_few_wide_rows(dev, sms, clock_mhz)}", flush=True)

        # Every public K1, K2 and K4 call above took k1k4_form's form, every
        # K3 call k3_form's and every K5 and K8 call k5_form's (formed,
        # k8_check); the int32 launches are the forms given for the
        # comparisons and the widths outside the rules.
        wide_forms = {k: {form: n - forms_14[k][form] for form, n in getattr(cuda_score, f"{k}_FORMS").items()}
                      for k in forms_14}
        fail_unless(all(min(f.values()) > 0 for f in wide_forms.values()),
                    f"K1-K5 and K8 at rows (reads) of more than 1,024 lanes took {wide_forms}")
        print(f"[14] launches at rows (reads) of 1,025-16,384 lanes by form: "
              + ", ".join(f"{k} {f}" for k, f in wide_forms.items()), flush=True)

        # The main path: every strategy on a corpus with reads of 1,025-8,000 bp.
        t14e = time.perf_counter()
        lr_root = os.path.join(work, "long_reads")
        os.makedirs(os.path.join(lr_root, "refs"))
        os.makedirs(os.path.join(lr_root, "inputs"))
        lr_refs = [piece(n) for n in rng.integers(500, 4001, 64)]
        lr_parts = (lr_refs[: len(lr_refs) // 2], lr_refs[len(lr_refs) // 2 :])
        for fi, part in enumerate(lr_parts):
            with open(os.path.join(lr_root, "refs", f"lr{fi}.rna.fna"), "w") as f:
                f.write("\n".join(f">gi|{fi}{k}|lr{fi}{k}\n{seq}" for k, seq in enumerate(part)))
        lr_reads = [piece(n) for n in rng.integers(80, 151, 120)]
        for k, n in enumerate((1025, 1100, 1500, 2048, 3000, 4096, 6000, 8000)):
            lr_reads.insert(15 * k + 7, piece(n))
        with open(os.path.join(lr_root, "inputs", "input1.fa"), "w") as f:
            f.write("\n".join(lr_reads))
        lr_config = AlignConfig(ref_dir=os.path.join(lr_root, "refs"), in_dir=os.path.join(lr_root, "inputs"),
                                out_dir=os.path.join(lr_root, "out_batch"))
        def k3_cut(args, kw):
            """Whether a K3 call's plan cuts its segments into pieces."""
            packed_a, ns_a = args[0], args[4]
            per = 8 if cuda_score.k3_form(packed_a.shape[1], *args[6:9], longest=kw.get("longest")) == "s16x2" else 4
            cols = kw.get("carry_cols") or int(ns_a.clamp_min(1).sum())
            return cuda_score.band_segments(packed_a.shape[1], cols, ns_a.shape[0], -(-packed_a.shape[0] // per),
                                            *args[6:9], sms, longest=kw.get("longest"))[0] < cols

        def k8_cut(args, kw):
            """Whether a K8 call's plan cuts its reference into segments."""
            (r_a, m_a), n_a = args[0].shape, args[1].shape[0]
            blocks = cuda_score._max_cells_blocks(r_a, m_a, cuda_score.k5_form(m_a, *args[3:6]))
            return cuda_score.max_cells_segments(m_a, n_a, *args[3:6], blocks, sms)[0] < n_a

        @contextlib.contextmanager
        def launch_log():
            """[(kernel, m, longest, forms, cut)] of every K1-K5 and K8
            launch the backends and the traceback make inside the block:
            their references to the six public wrappers wrapped for it,
            each launch's form read from K1_FORMS .. K8_FORMS, and for K3
            and K8 whether its plan cut it into column pieces (None
            elsewhere)."""
            from sparksmithwaterman_tpu_torch.models import batch_backend
            from sparksmithwaterman_tpu_torch.parallel import engine, seqparallel

            log = []

            def spy(kernel, fn, counts):
                cut = {"K3": k3_cut, "K8": k8_cut}.get(kernel)

                def call(*args, **kw):
                    before = dict(counts)
                    out = fn(*args, **kw)
                    log.append((kernel, args[0].shape[1], kw.get("longest"),
                                [form for form in counts if counts[form] != before[form]],
                                cut and cut(args, kw)))
                    return out
                return call

            kernel_of = {"lane_best_packed_varlen": "K1", "argmax_lane": "K2", "score_grid_diag": "K4",
                         "score_grid_row": "K5", "band_lane_best": "K3", "max_cells_row": "K8"}
            saved = [(batch_backend, "lane_best_packed_varlen"), (engine, "lane_best_packed_varlen"),
                     (batch_backend, "score_grid_diag"), (batch_backend, "score_grid_row"), (longseq, "argmax_lane"),
                     (seqparallel, "band_lane_best"), (longseq, "max_cells_row")]
            saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
            for mod, name, fn in saved:
                k = kernel_of[name]
                setattr(mod, name, spy(k, fn, getattr(cuda_score, f"{k}_FORMS")))
            try:
                yield log
            finally:
                for mod, name, fn in saved:
                    setattr(mod, name, fn)

        def check_log(log, what, rule=None):
            """Every launch of the log in the form its rule gives it (K5 and
            K8 k5_form, K3 k3_form, the others k1k4_form; ``rule(kernel, m,
            longest)``: another rule's), each launch one form; the wide
            launches by kernel and form."""
            rule = rule or (lambda kernel, m, longest: cuda_score.k5_form(m, *PARAMS) if kernel in ("K5", "K8") else
                            cuda_score.k3_form(m, *PARAMS, longest=longest) if kernel == "K3" else
                            cuda_score.k1k4_form(m, *PARAMS, longest=longest))
            wide = collections.Counter()
            for kernel, m, longest, forms, _ in log:
                fail_unless(forms == [rule(kernel, m, longest)],
                            f"{what}: {kernel} at {m} lanes (longest {longest}) took {forms}")
                if m > cuda_score.ONE_PASS_LANES:
                    wide[kernel, forms[0]] += 1
            return wide

        cuda_score.reset_launches()
        lr_s = {}
        with launch_log() as lr_log:
            for strategy in ("batch", "wavefront", "shard_refs", "shard_reads", "shard_seq"):
                lr_s[strategy] = align(lr_root, strategy, f"out_{strategy}")
            for name, kw in (("unpacked", dict(pack_reads=False)), ("row", dict(kernel="row"))):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run_pipeline(dataclasses.replace(lr_config, out_dir=os.path.join(lr_root, f"out_{name}"), **kw),
                             device=dev)
                torch.cuda.synchronize()
                lr_s[name] = time.perf_counter() - t
        # The 8,000 bp read is outside the rule: K1 packs it alone in int32
        # and the other reads in s16x2 (8,192-lane rows both), K2 pads every
        # read to the longest and stays int32; K4's and K5's read groups of
        # 1,025-6,000 bp take s16x2, the 8,000 bp one int32.
        lr_wide = check_log(lr_log, "the long-read paths")
        fail_unless(all(lr_wide[k, form] > 0 for k in ("K1", "K4", "K5") for form in ("s16x2", "int32")),
                    f"the long-read paths' wide launches by form: {dict(lr_wide)}")
        lr_launches = dict(cuda_score.LAUNCHES)
        lr_forms = dict(cuda_score.K1_FORMS)
        fail_unless(lr_forms["int32"] > 0 and sum(lr_forms.values()) == lr_launches["lane_best_packed_varlen"],
                    f"K1's forms on the long-read paths: {lr_forms} of {lr_launches['lane_best_packed_varlen']}")
        k1_main_forms.update(lr_forms)
        lr_k4_forms = dict(cuda_score.K4_FORMS)
        fail_unless(min(lr_k4_forms.values()) > 0 and sum(lr_k4_forms.values()) == lr_launches["score_grid_diag"],
                    f"K4's forms on the long-read paths: {lr_k4_forms} of {lr_launches['score_grid_diag']}")
        k4_main_forms.update(lr_k4_forms)
        lr_k3_forms = dict(cuda_score.K3_FORMS)
        fail_unless(sum(lr_k3_forms.values()) == lr_launches["band_lane_best"],
                    f"K3's forms on the long-read paths: {lr_k3_forms} of {lr_launches['band_lane_best']}")
        k3_main_forms = {form: k3_main_forms[form] + lr_k3_forms[form] for form in k3_main_forms}
        lr_k5_forms = dict(cuda_score.K5_FORMS)
        fail_unless(min(lr_k5_forms.values()) > 0 and sum(lr_k5_forms.values()) == lr_launches["score_grid_row"],
                    f"K5's forms on the long-read paths: {lr_k5_forms} of {lr_launches['score_grid_row']}")
        k5_main_forms.update(lr_k5_forms)
        k8_main_forms.update(cuda_score.K8_FORMS)
        k2_main_forms.update(cuda_score.K2_FORMS)
        fail_unless(all(lr_launches[k] > 0 for k in ("lane_best_packed_varlen", "argmax_lane", "band_lane_best",
                                                      "score_grid_diag", "score_grid_row")),
                    f"a kernel of K1-K5 never launched on the long-read paths: {lr_launches}")
        want_report = stripped(os.path.join(lr_root, "out_batch", "result1.txt"))
        for name in lr_s:
            fail_unless(stripped(os.path.join(lr_root, f"out_{name}", "result1.txt")) == want_report,
                        f"the long-read report of {name} differs from batch's")
        max_score, winners = parse_report(os.path.join(lr_root, "out_batch", "result1.txt"))
        lr_seqs = {f">gi|{fi}{k}|lr{fi}{k}": seq for fi, part in enumerate(lr_parts) for k, seq in enumerate(part)}
        lr_reads_t = up(encode_batch(lr_reads, 8000, READ_PAD))
        lr_backend = TorchBatchBackend(lr_config, dev)
        n_sites, branches = 0, set()
        for meta, sites in winners.items():
            seq = lr_seqs[meta]
            total = int(score_grid(lr_reads_t, up(encode_batch([seq], len(seq), REF_PAD)), *PARAMS).sum())
            fail_unless(total == max_score, f"long-read winner {meta}: total {total} != reported {max_score}")
            windowed = lr_backend._windowed(seq, lr_reads)
            branches.add("windowed" if windowed else "full-fill")
            if windowed:
                cells = find_max_cells_batched(lr_reads, seq, PARAMS, device=dev)
                per_read = sites_for_ref_long_batched(seq, lr_reads, PARAMS, cell_lists=cells, device=dev)
            else:
                per_read = [lr_backend.sites_for_ref(seq, [r]) for r in lr_reads]
            merged = sorted((s for p in per_read for s in p), key=lambda site: site[0])
            fail_unless(merged == sites, f"long-read report sites against {meta} differ from the per-read recomputation")
            n_sites += len(sites)
        print(f"[14] {len(lr_reads)} reads (8 of 1,025-8,000 bp) x {len(lr_refs)} refs of 500-4,000 bp: reports of "
              f"{', '.join(f'{k} {v:.2f} s' for k, v in lr_s.items())} equal apart from the time line; max score "
              f"{max_score}, {len(winners)} winner(s) equal to the row-form recurrence; all {n_sites} sites equal the "
              f"per-read recomputation ({'/'.join(sorted(branches))} branch); {time.perf_counter() - t14e:.1f} s "
              f"with the checks", flush=True)
        print(f"[14] the traceback's launches over the long-read paths: {traced(lr_launches, 'phase 14')}", flush=True)
        print(f"[14] LAUNCHES over the long-read paths: {lr_launches}, K1 forms {lr_forms}, K3 forms {lr_k3_forms}, "
              f"K4 forms {lr_k4_forms}, "
              f"K5 forms {lr_k5_forms}; K1's and K4's launches at rows (reads) of more than 1,024 lanes by form "
              f"{dict(lr_wide)}", flush=True)

        # The main path on long reads of 1,025-6,000 bp, inside the rules:
        # swtorch align --strategy batch (K1 at 8,192 lanes, its longest read
        # 6,000 bp; the windowed traceback's K2 on every read padded to
        # 6,000), wavefront with pack_reads=False (K4 a read group at a time)
        # and run_pipeline with kernel='row' (K5 likewise), each against the
        # same run with the rules giving int32 past one pass.
        t14s = time.perf_counter()
        lr6_root = os.path.join(work, "long_reads_6k")
        shutil.copytree(os.path.join(lr_root, "refs"), os.path.join(lr6_root, "refs"))
        os.makedirs(os.path.join(lr6_root, "inputs"))
        lr6_reads = [read for read in lr_reads if len(read) != 8000]
        with open(os.path.join(lr6_root, "inputs", "input1.fa"), "w") as f:
            f.write("\n".join(lr6_reads))
        lr6_config = dataclasses.replace(lr_config, in_dir=os.path.join(lr6_root, "inputs"), strategy="wavefront",
                                         pack_reads=False)

        def lr6_runs(form):
            """The three reports of the 6,000 bp corpus (time line left out)."""
            align(lr6_root, "batch", f"out_batch_{form}")
            run_pipeline(dataclasses.replace(lr6_config, out_dir=os.path.join(lr6_root, f"out_wavefront_{form}")),
                         device=dev)
            run_pipeline(dataclasses.replace(lr6_config, strategy="batch", kernel="row",
                                             out_dir=os.path.join(lr6_root, f"out_row_{form}")), device=dev)
            torch.cuda.synchronize()
            return [stripped(os.path.join(lr6_root, f"out_{name}_{form}", "result1.txt"))
                    for name in ("batch", "wavefront", "row")]

        cuda_score.reset_launches()
        with launch_log() as lr6_log:
            lr6 = lr6_runs("s16x2")
        lr6_launches = dict(cuda_score.LAUNCHES)
        lr6_forms = {k: dict(getattr(cuda_score, f"{k}_FORMS")) for k in ("K1", "K2", "K4", "K5", "K8")}
        lr6_wide = check_log(lr6_log, "the 6,000 bp corpus")
        fail_unless(all(lr6_wide[k, "s16x2"] > 0 and not lr6_wide[k, "int32"] for k in ("K1", "K2", "K4", "K5")),
                    f"the 6,000 bp corpus's wide launches by form: {dict(lr6_wide)}")
        # Its batch run's winners took the windowed traceback, whose K2
        # pads every read to the longest (the wide launch above).
        lr6_backend = TorchBatchBackend(lr6_config, dev)
        lr6_winners = parse_report(os.path.join(lr6_root, "out_batch_s16x2", "result1.txt"))[1]
        fail_unless(all(lr6_backend._windowed(lr_seqs[meta], lr6_reads) for meta in lr6_winners),
                    f"a winner of the 6,000 bp corpus took the full-fill branch: {sorted(lr6_winners)}")
        k1_main_forms.update(lr6_forms["K1"])
        k2_main_forms.update(lr6_forms["K2"])
        k4_main_forms.update(lr6_forms["K4"])
        k5_main_forms.update(lr6_forms["K5"])
        k8_main_forms.update(lr6_forms["K8"])
        rules = cuda_score.k1k4_form, cuda_score.k5_form
        cuda_score.k1k4_form = lambda m, *a, **kw: "int32" if m > cuda_score.ONE_PASS_LANES else rules[0](m, *a, **kw)
        cuda_score.k5_form = lambda m, *a: "int32" if m > cuda_score.ONE_PASS_LANES else rules[1](m, *a)
        try:
            with launch_log() as lr6_int32_log:
                lr6_int32 = lr6_runs("int32")
        finally:
            cuda_score.k1k4_form, cuda_score.k5_form = rules
        lr6_int32_wide = check_log(lr6_int32_log, "the 6,000 bp corpus in int32",
                                   lambda kernel, m, longest: "int32" if m > cuda_score.ONE_PASS_LANES else
                                   cuda_score.k1_form(m, *PARAMS))
        # The traceback's K2 call of the batch run's winner, as
        # find_max_cells_batched makes it (every read padded to the longest,
        # a multiple of 8), in both wide forms in turns by events; the
        # s16x2 form's early stop on pad rows runs a short read's first
        # stripes only, where the int32 form runs all of them.
        lr6_winner = lr_seqs[sorted(lr6_winners)[0]]
        args_2m = (up(encode_batch(lr6_reads, -(-max(map(len, lr6_reads)) // 8) * 8, READ_PAD)),
                   up(encode_batch([lr6_winner], len(lr6_winner), REF_PAD)))
        k2m_turns, k2m_outs = in_turns(lambda form: cuda_score._argmax_lane(*args_2m, *PARAMS, form=form), 3)
        fail_unless(consumed_err(k2m_outs["s16x2"], k2m_outs["int32"], "the 6,000 bp corpus's winner") == 0,
                    "K2's wide forms differ on the traceback's lanes of the 6,000 bp corpus's winner")
        k2m_ms = {form: float(np.mean(t)) for form, t in k2m_turns.items()}
        print(f"[14] K2 as the traceback calls it on the 6,000 bp corpus ({args_2m[0].shape[0]} reads padded to "
              f"{args_2m[0].shape[1]} x the {len(lr6_winner)} bp winner), in turns (events): int32, s16x2, s16x2, "
              f"int32 " + ", ".join(f"{t:.3f}" for t in (k2m_turns["int32"][0], *k2m_turns["s16x2"], k2m_turns["int32"][1]))
              + f" ms ({k2m_ms['int32'] / k2m_ms['s16x2']:.2f}x), equal on the traceback's lanes", flush=True)
        fail_unless(lr6 == lr6_int32 and lr6[0] == lr6[1] == lr6[2],
                    "the 6,000 bp corpus's reports differ between the s16x2 and the int32 wide forms, or between "
                    "batch, wavefront and the row form")
        print(f"[14] {len(lr6_reads)} reads (7 of 1,025-6,000 bp) x {len(lr_refs)} refs: swtorch align --strategy "
              f"batch, wavefront with pack_reads=False and kernel='row', reports equal to the same runs in the int32 "
              f"wide forms and to each other; winners {sorted(lr6_winners)} through the windowed traceback; wide "
              f"launches by form {dict(lr6_wide)} (int32 runs {dict(lr6_int32_wide)}); LAUNCHES {lr6_launches}; "
              f"{time.perf_counter() - t14s:.1f} s", flush=True)

        # The main path past one pass for K3 and K8 in s16x2: 60 reads of
        # 80-150 bp and four of 1,025-3,000 bp, one of 2,000 bp held twice by
        # a 48 kb winner (a tie inside its last DP row, which the windowed
        # traceback lists with K8 at 2,000 positions, in segments), x that
        # winner and four refs of 9-40 kb.  shard_seq packs every read in
        # rows of 4,096 lanes (the longest read 3,000 bp: K3 in s16x2) and
        # cuts the refs past 4 W = 27,000 columns into pieces.  The batch and
        # shard_seq reports equal each other, shard_seq's with k3_form patched
        # to int32 past one pass, and batch's with K8's rule patched to
        # k1_form.
        t14b = time.perf_counter()
        kb_root = os.path.join(work, "long_band")
        os.makedirs(os.path.join(kb_root, "refs"))
        os.makedirs(os.path.join(kb_root, "inputs"))
        tie_read = "".join(k38_rng.choice(list("ACGT"), size=2000))
        win = rand_seqs(k38_rng, [48_000])[0]
        win = win[:6_000] + tie_read + win[8_000:30_000] + tie_read + win[32_000:]
        kb_refs = [win] + rand_seqs(k38_rng, [40_000, 33_000, 9_000, 15_000])
        with open(os.path.join(kb_root, "refs", "kb.rna.fna"), "w") as f:
            f.write("\n".join(f">gi|9{k}|kb{k}\n{seq}" for k, seq in enumerate(kb_refs)))

        def from_win(n):
            """n bp of the winner with about one base in 30 changed."""
            o = int(k38_rng.integers(0, len(win) - n + 1))
            arr = np.frombuffer(win[o : o + n].encode(), np.uint8).copy()
            hit = k38_rng.random(n) < 1 / 30
            arr[hit] = np.frombuffer(b"ACGT", np.uint8)[k38_rng.integers(0, 4, int(hit.sum()))]
            return arr.tobytes().decode()

        kb_reads = [from_win(int(n)) for n in k38_rng.integers(80, 151, 60)]
        kb_reads[10:10] = [from_win(1025), from_win(1500), tie_read, from_win(3000)]
        with open(os.path.join(kb_root, "inputs", "input1.fa"), "w") as f:
            f.write("\n".join(kb_reads))
        cuda_score.reset_launches()
        with launch_log() as kb_log:
            kb_s = {strategy: align(kb_root, strategy, f"out_{strategy}") for strategy in ("batch", "shard_seq")}
        kb_launches = dict(cuda_score.LAUNCHES)
        kb_forms = {k: dict(getattr(cuda_score, f"{k}_FORMS")) for k in ("K1", "K2", "K3", "K4", "K5", "K8")}
        kb_wide = check_log(kb_log, "the long-band corpus")
        kb_cut = {k: [(forms, cut) for kernel, m, _, forms, cut in kb_log if kernel == k and m > cuda_score.ONE_PASS_LANES]
                  for k in ("K3", "K8")}
        fail_unless(all(kb_cut[k] and all(forms == ["s16x2"] and cut for forms, cut in kb_cut[k]) for k in kb_cut),
                    f"K3's and K8's launches past one pass on the long-band corpus (form, cut): {kb_cut}")
        kb_winners = parse_report(os.path.join(kb_root, "out_batch", "result1.txt"))[1]
        fail_unless(list(kb_winners) == [">gi|90|kb0"] and TorchBatchBackend(lr_config, dev)._windowed(win, kb_reads),
                    f"the long-band corpus's winner is not its 48 kb ref through the windowed branch: {list(kb_winners)}")
        rules = cuda_score.k3_form, cuda_score.k5_form
        cuda_score.k3_form = lambda m, *a, **kw: "int32" if m > cuda_score.ONE_PASS_LANES else rules[0](m, *a, **kw)
        try:
            with launch_log() as kb3_log:
                align(kb_root, "shard_seq", "out_shard_seq_int32")
        finally:
            cuda_score.k3_form = rules[0]
        cuda_score.k5_form = cuda_score.k1_form
        try:
            with launch_log() as kb8_log:
                align(kb_root, "batch", "out_batch_int32")
        finally:
            cuda_score.k5_form = rules[1]
        kb3_wide = check_log(kb3_log, "the long-band corpus, K3 in int32",
                             lambda kernel, m, longest: "int32" if kernel == "K3" and m > cuda_score.ONE_PASS_LANES
                             else rules[1](m, *PARAMS) if kernel in ("K5", "K8")
                             else cuda_score.k1k4_form(m, *PARAMS, longest=longest))
        kb8_wide = check_log(kb8_log, "the long-band corpus, K8 by k1_form",
                             lambda kernel, m, longest: cuda_score.k1_form(m, *PARAMS) if kernel in ("K5", "K8")
                             else cuda_score.k1k4_form(m, *PARAMS, longest=longest))
        fail_unless(kb3_wide["K3", "int32"] > 0 and kb8_wide["K8", "int32"] > 0
                    and all(cut for kernel, m, _, _, cut in kb3_log if kernel == "K3" and m > cuda_score.ONE_PASS_LANES),
                    f"the int32-patched runs' wide launches: {dict(kb3_wide)}, {dict(kb8_wide)}")
        kb_reports = [stripped(os.path.join(kb_root, out, "result1.txt"))
                      for out in ("out_batch", "out_shard_seq", "out_shard_seq_int32", "out_batch_int32")]
        fail_unless(all(r == kb_reports[0] for r in kb_reports),
                    "the long-band corpus's reports differ between batch, shard_seq and their int32-patched runs")
        k1_main_forms.update(kb_forms["K1"])
        k2_main_forms.update(kb_forms["K2"])
        k4_main_forms.update(kb_forms["K4"])
        k5_main_forms.update(kb_forms["K5"])
        k8_main_forms.update(kb_forms["K8"])
        k3_main_forms = {form: k3_main_forms[form] + kb_forms["K3"][form] for form in k3_main_forms}
        print(f"[14] {len(kb_reads)} reads (4 of 1,025-3,000 bp, one of 2,000 bp tied in the winner) x "
              f"{len(kb_refs)} refs of 9-48 kb: batch {kb_s['batch']:.2f} s and shard_seq {kb_s['shard_seq']:.2f} s, "
              f"reports equal to each other and to shard_seq with K3 int32 past one pass and batch with K8 by "
              f"k1_form; winner {list(kb_winners)} through the windowed traceback; K3's and K8's launches past one "
              f"pass (form, cut into pieces) {kb_cut}; wide launches by form {dict(kb_wide)} (int32 runs "
              f"{dict(kb3_wide)}, {dict(kb8_wide)}); LAUNCHES {kb_launches}; {time.perf_counter() - t14b:.1f} s",
              flush=True)
        wide_main_forms = {k: {form: lr_wide[k, form] + lr6_wide[k, form] + kb_wide[k, form] for form in ("s16x2", "int32")}
                           for k in ("K1", "K2", "K3", "K4", "K5", "K8")}
        clock.done(14)

        # -- 15. swtorch gen, info, bench and diff; two processes; the dry run --
        legs_15 = []  # (launches, forms) of each main-path leg of phase 15

        def read_leg(what):
            """Append the launches and forms since the last reset as a leg;
            return the launches."""
            forms = {k: dict(getattr(cuda_score, f"{k}_FORMS")) for k in ("K1", "K2", "K3", "K4", "K5", "K8")}
            legs_15.append((dict(cuda_score.LAUNCHES), forms))
            return legs_15[-1][0]

        def swtorch(argv):
            """(exit code, standard output) of ``swtorch`` in this process."""
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            return rc, buf.getvalue()

        sweeps_root = os.path.join(work, "sweeps")
        t = time.perf_counter()
        for sweeps, scale in ((["read_num", "read_len", "ref_len"], "1.0"), (["ref_num"], str(REF_NUM_SCALE))):
            rc, out = swtorch(["gen", "--out-dir", sweeps_root, "--sweeps", *sweeps, "--scale", scale])
            fail_unless(rc == 0 and out.strip() == sweeps_root, f"swtorch gen {sweeps} exited {rc}: {out[-300:]}")
        gen_s = time.perf_counter() - t
        tree = {sub: sorted(os.listdir(os.path.join(sweeps_root, *sub.split("/"))))
                for sub in ("input/readNum", "input/readLen", "testRef/refNum", "testRef/refLen")}
        fail_unless([len(v) for v in tree.values()] == [33, 25, 9, 36], f"swtorch gen wrote {tree}")
        gen_bp = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(sweeps_root) for f in fs)
        print(f"[15] swtorch gen: read_num (33 files of 20-1,600 reads x 80 bp), read_len (25 files of 5 reads x "
              f"20-500 bp), ref_len (36 refs of 80 bp-128 kb) at --scale 1.0; ref_num cut to --scale {REF_NUM_SCALE} "
              f"(9 dirs of 1-2,000 refs of 400 bp, not 28 dirs up to 40,000); {gen_bp} bytes in {gen_s:.2f} s",
              flush=True)

        ref_len_dir = os.path.join(sweeps_root, "testRef", "refLen")
        info_text, info_s = {}, {}
        for threads in ("1", "8"):
            out_file = os.path.join(work, f"info_threads{threads}.txt")
            t = time.perf_counter()
            rc, out = swtorch(["info", "--ref-dir", ref_len_dir, "--out-file", out_file, "--threads", threads])
            info_s[threads] = time.perf_counter() - t
            fail_unless(rc == 0 and out.strip() == out_file, f"swtorch info --threads {threads} exited {rc}")
            info_text[threads] = open(out_file, "rb").read()
        fail_unless(info_text["1"] == info_text["8"], "swtorch info --threads 1 and 8 wrote different files")
        fail_unless(b"# files  =  36\n" in info_text["1"] and b"max     =  128,000" in info_text["1"],
                    f"swtorch info on the ref_len tree: {info_text['1'][:400]!r}")
        print(f"[15] swtorch info on the ref_len tree: --threads 1 ({info_s['1']:.3f} s) and --threads 8 "
              f"({info_s['8']:.3f} s) wrote the same {len(info_text['1'])} bytes", flush=True)

        bench_out = os.path.join(work, "sweeps_out")
        cuda_score.reset_launches()
        t = time.perf_counter()
        rc, out = swtorch(["bench", "--data-dir", sweeps_root, "--out-dir", bench_out, "--strategy", "batch",
                           "--device", "cuda"])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t
        sweep_launches = read_leg("bench")
        fail_unless(rc == 0, f"swtorch bench exited {rc}")
        sweep_rows = json.loads(out)
        fail_unless({k: len(v) for k, v in sweep_rows.items()} == {"read_num": 33, "read_len": 25, "ref_num": 9,
                                                                    "ref_len": 36}, f"swtorch bench cases: {out[:300]}")
        for sweep, sub in (("read_num", "readNum"), ("read_len", "readLen"), ("ref_num", "refNum"),
                           ("ref_len", "refLen")):
            rows = sweep_rows[sweep]
            fail_unless(all(r["ms"] >= 0 for r in rows), f"swtorch bench {sweep}: a case without its time: {rows}")
            for r in rows:
                report = os.path.join(bench_out, "batch", sub, os.path.basename(r["case"]))
                fail_unless(os.path.exists(report) and "Maximum alignment score = " in open(report).read(),
                            f"swtorch bench {sweep}: no report for {r['case']}")
            with open(os.path.join(bench_out, "batch", f"{sweep}_summary.json")) as f:
                fail_unless(json.load(f) == rows, f"swtorch bench {sweep}: its summary file differs from its rows")
        fail_unless(sweep_launches["lane_best_packed_varlen"] > 0, f"swtorch bench never launched K1: {sweep_launches}")
        sweep_ms = {sweep: sum(r["ms"] for r in rows) for sweep, rows in sweep_rows.items()}
        print(f"[15] swtorch bench --strategy batch, all four sweeps: {sum(len(v) for v in sweep_rows.values())} "
              f"cases, each a report; total {sum(sweep_ms.values())} ms by the reports {sweep_ms}, {sweep_s:.2f} s "
              f"wall; launches {sweep_launches}; the traceback's {traced(sweep_launches, 'swtorch bench')}",
              flush=True)

        diff_args = ["diff", "--ref-dir", os.path.join(slice_root, "refs"), "--in-dir",
                     os.path.join(slice_root, "inputs"), "--device", "cuda"]
        cuda_score.reset_launches()
        t = time.perf_counter()
        rc, out = swtorch(diff_args + ["--out-dir", os.path.join(work, "diff_seq"), "--strategy-a", "batch",
                                       "--strategy-b", "shard_seq"])
        diff_s = time.perf_counter() - t
        diff_launches = read_leg("diff batch shard_seq")
        fail_unless(rc == 0 and out.splitlines()[-1] == "identical: batch vs shard_seq (2 report(s), timing line "
                    "ignored)", f"swtorch diff batch shard_seq exited {rc}: {out[-500:]}")
        fail_unless(diff_launches["lane_best_packed_varlen"] > 0 and diff_launches["band_lane_best"] > 0,
                    f"swtorch diff batch shard_seq did not launch K1 and K3: {diff_launches}")
        print(f"[15] swtorch diff --strategy-a batch --strategy-b shard_seq on the phase-3 corpus: identical, "
              f"{diff_s:.2f} s; launches {diff_launches}", flush=True)

        tiny_root = os.path.join(work, "tiny")
        os.makedirs(os.path.join(tiny_root, "refs"))
        os.makedirs(os.path.join(tiny_root, "inputs"))
        for fi in (1, 2):
            with open(os.path.join(tiny_root, "refs", f"ref{fi}.rna.fna"), "w") as f:
                f.write("\n".join(f">gi|{fi}{j}|tiny\n{seq}" for j, seq in enumerate(
                    rand_seqs(rng, rng.integers(60, 200, size=3)))))
        with open(os.path.join(tiny_root, "inputs", "input1.fa"), "w") as f:
            f.write("\n".join(rand_seqs(rng, rng.integers(10, 40, size=6))))
        tiny_args = ["diff", "--ref-dir", os.path.join(tiny_root, "refs"), "--in-dir",
                     os.path.join(tiny_root, "inputs"), "--device", "cuda"]
        cuda_score.reset_launches()
        rc, out = swtorch(tiny_args + ["--out-dir", os.path.join(tiny_root, "d1")])
        serial_launches = read_leg("diff serial batch")
        fail_unless(rc == 0 and out.splitlines() == ["OK  result1.txt", "identical: serial vs batch (1 report(s), "
                    "timing line ignored)"], f"swtorch diff serial batch exited {rc}: {out[-500:]}")
        real_run = diff_module.run_pipeline

        def doctored(cfg, **kw):
            """The pipeline, then batch's report edited: a report made to diverge."""
            paths = real_run(cfg, **kw)
            if cfg.strategy == "batch":
                with open(paths[0]) as f:
                    text = f.read()
                with open(paths[0], "w") as f:
                    f.write(text.replace("Maximum alignment score = ", "Maximum alignment score = 1", 1))
            return paths

        diff_module.run_pipeline = doctored
        try:
            cuda_score.reset_launches()
            rc, out = swtorch(tiny_args + ["--out-dir", os.path.join(tiny_root, "d2")])
            read_leg("diff serial batch, diverged")
        finally:
            diff_module.run_pipeline = real_run
        fail_unless(rc == 1 and out.splitlines()[0] == "DIFF result1.txt" and "+Maximum alignment score = 1" in out
                    and out.splitlines()[-1] == "DIVERGED: serial vs batch (1 report(s), timing line ignored)",
                    f"a diverged report: swtorch diff exited {rc}: {out[-500:]}")
        print(f"[15] swtorch diff --strategy-a serial --strategy-b batch on 6 reads x 6 refs: identical (launches "
              f"{serial_launches}); with batch's report edited: DIVERGED, exit 1", flush=True)

        # Two processes on this card over gloo, the phase-3 corpus with its
        # references in two files, so that each process's shard holds one.
        mh_root = os.path.join(work, "multihost")
        half = len(slice_refs) // 2
        for fi, recs in ((1, slice_refs[:half]), (2, slice_refs[half:])):
            os.makedirs(os.path.join(mh_root, "refs"), exist_ok=True)
            with open(os.path.join(mh_root, "refs", f"ref{fi}.rna.fna"), "w") as f:
                f.write("\n".join(f"{meta}\n{seq}" for meta, seq in recs))
        mh_files = list(iter_files(os.path.join(mh_root, "refs")))
        fail_unless(all(shard_manifest(mh_files, 2, h) for h in (0, 1)), f"a process's shard is empty: {mh_files}")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH")) if p))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # both processes on this host: gloo over the loopback
        t = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _MULTIHOST_DRIVER, str(pid), os.path.join(mh_root, "refs"),
                 os.path.join(slice_root, "inputs"), os.path.join(mh_root, "out"), os.path.join(mh_root, "rdv")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for pid in (0, 1)
        ]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        mh_s = time.perf_counter() - t
        runs = {}
        for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
            fail_unless(p.returncode == 0, f"multi-host process {pid} exited {p.returncode}: {err[-2000:]}")
            runs[pid] = [json.loads(l[len("LAUNCHES "):]) for l in out.splitlines() if l.startswith("LAUNCHES ")]
            fail_unless([r["resume"] for r in runs[pid]] == [False, True], f"process {pid} printed {out[-500:]}")
        for pid in (0, 1):
            first, again = runs[pid]
            fail_unless(first["launches"]["lane_best_packed_varlen"] > 0,
                        f"process {pid} scored its shard without K1: {first['launches']}")
            fail_unless(sum(again["launches"][k] for k in ("lane_best_packed_varlen", "band_lane_best",
                                                           "score_grid_diag", "score_grid_row")) == 0,
                        f"process {pid} scored again while resuming from its journal: {again['launches']}")
            for run in (first, again):
                legs_15.append((run["launches"], run["forms"]))
        for k in (1, 2):
            fail_unless(stripped(os.path.join(mh_root, "out", f"result{k}.txt"))
                        == stripped(os.path.join(slice_root, "out", f"result{k}.txt")),
                        f"the two-process report result{k}.txt differs from phase 3's")
        print(f"[15] run_multihost_pipeline, 2 processes on {dev} over gloo (file:// rendezvous), the phase-3 "
              f"corpus in 2 ref files: process 0's reports equal phase 3's apart from the time line; K1 launches "
              f"{[runs[pid][0]['launches']['lane_best_packed_varlen'] for pid in (0, 1)]}, resumed from the "
              f"journals {[runs[pid][1]['launches']['lane_best_packed_varlen'] for pid in (0, 1)]}; {mh_s:.2f} s "
              f"for both runs with the processes' start", flush=True)
        print(f"[15] LAUNCHES of process 0, then process 1, run then resume: "
              f"{[r['launches'] for pid in (0, 1) for r in runs[pid]]}", flush=True)

        cuda_score.reset_launches()
        dry = dryrun_multichip(4)
        torch.cuda.synchronize()
        dry_launches = read_leg("dry run")
        fail_unless(dry["mesh"] == {"refs": 2, "reads": 2} and dry_launches["score_grid_diag"] > 0,
                    f"the dry run: {dry}, launches {dry_launches}")
        print(f"[15] dryrun_multichip(4): a (2, 2) mesh of {sorted(set(dry['devices']))}, sharded_totals and "
              f"sharded_score_grid equal the unsharded plain grid; launches {dry_launches}", flush=True)

        for _, forms in legs_15:
            k1_main_forms.update(forms["K1"])
            k2_main_forms.update(forms["K2"])
            k4_main_forms.update(forms["K4"])
            k5_main_forms.update(forms["K5"])
            k8_main_forms.update(forms["K8"])
            k3_main_forms = {form: k3_main_forms[form] + forms["K3"][form] for form in k3_main_forms}
        launches_15 = [leg for leg, _ in legs_15]
        clock.done(15)

    legs = (launches, seq_launches, seq_batch_launches, shard_launches, unpacked_launches, scaling_launches,
            *bench_launches.values(), *probe_launches.values(), lr_launches, lr6_launches, kb_launches, *launches_15)
    main_launches = {name: sum(leg[name] for leg in legs) for name in cuda_score.LAUNCHES}
    fail_unless(main_launches["fill_list"] > 0 and main_launches["fill_walk"] > 0,
                f"the main-path legs did not run both branches of the traceback: {main_launches}")

    kernels = [
        {
            "name": "lane_best_packed_varlen",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/lane_best.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:865",
            "also_replaces": [
                f"sparksmithwaterman_tpu/ops/pallas_score.py:{line}" for line in (1801, 1310, 1365, 1420, 460)
            ],
            "launches": main_launches["lane_best_packed_varlen"],
            "max_abs_err": k1_max_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": k1_bound_by,
            "library_ms": None,
            "forms": dict(k1_main_forms),
            "int32_ms": k1_int32_ms,
            "long_ms": kl_ms,
            "long_plain_ms": kl_plain_ms,
            "long_bound_ms": kl_bound_ms,
        },
        {
            "name": "argmax_lane",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/argmax.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:2214",
            "launches": main_launches["argmax_lane"],
            "max_abs_err": k2_max_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by,
            "library_ms": None,
            "forms": dict(k2_main_forms),
            "int32_ms": k2_int32_ms,
            "long_ms": k2l_ms,
            "long_bound_ms": k2l_bound_ms,
            "long_segments": k2l_plan[3],
            "long_unsplit_ms": k2l_unsplit_ms,
            "long_unsplit_bound_ms": k2l_bound_ms,
            "long_int32_ms": k2l_int32_ms,
            "longref_ms": k2x_ms,
            "longref_bound_ms": k2x_bound_ms,
            "longref_int32_ms": k2x_int32_ms,
        },
        {
            "name": "band_lane_best",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/band.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:2379",
            "launches": main_launches["band_lane_best"],
            "max_abs_err": k3_max_err,
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound_ms,
            "bound_by": k3_bound_by,
            "library_ms": None,
            "forms": k3_main_forms,
            "unsplit_ms": k3_t["unsplit"],
            "int32_ms": k3_t["int32"],
            "long_ms": k3l_ms,
            "long_bound_ms": k3l_bound_ms,
            "long_pieces": {"stride": plan_5l[0], "look_back": plan_5l[1]},
            "long_unsplit_ms": k3l_t["unsplit"],
            "long_int32_ms": k3l_t["int32"],
            "mixed_ms": k3x_t["public"],
            "mixed_bound_ms": k3x_bound_ms,
            "mixed_pieces": {"stride": plan_5x[0], "look_back": plan_5x[1]},
            "mixed_unsplit_ms": k3x_t["unsplit"],
            "mixed_int32_ms": k3x_t["int32"],
        },
        {
            "name": "score_grid_diag",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/score_grid.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:182",
            "also_replaces": [f"sparksmithwaterman_tpu/ops/pallas_score.py:{line}" for line in (2051, 482)],
            "launches": main_launches["score_grid_diag"],
            "max_abs_err": k4_max_err,
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": grid_bound_ms,
            "bound_by": grid_bound_by,
            "library_ms": None,
            "forms": dict(k4_main_forms),
            "int32_ms": k4_int32_ms,
            "lanes150_ms": k4_ab["150"]["s16x2"],
            "lanes150_int32_ms": k4_ab["150"]["int32"],
            "lanes150_bound_ms": k4_150_bound_ms,
            "long_ms": k4l_ms,
            "long_int32_ms": k4_ab["131k"]["int32"],
            "long_bound_ms": k4l_bound_ms,
        },
        {
            "name": "score_grid_row",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/score_row.cu",
            "replaces": "sparksmithwaterman_tpu/ops/pallas_score.py:71",
            "launches": main_launches["score_grid_row"],
            "max_abs_err": k5_max_err,
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": grid_bound_ms,
            "bound_by": grid_bound_by,
            "library_ms": None,
            "forms": dict(k5_main_forms),
            "int32_ms": k5_int32_ms,
            "lanes150_ms": k5_ab["150"]["s16x2"],
            "lanes150_int32_ms": k5_ab["150"]["int32"],
            "lanes150_bound_ms": k4_150_bound_ms,
            "long_ms": k5_ab["131k"]["s16x2"],
            "long_int32_ms": k5_ab["131k"]["int32"],
            "long_bound_ms": k5l_bound_ms,
            "long_segments": k5_segments,
            "long_unsplit_ms": k5_unsplit_ms,
            "long_unsplit_bound_ms": k5l_bound_ms,
        },
        {
            "name": "step_chain_best",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/step_chain.cu",
            "replaces": "sparksmithwaterman_tpu/ops/microbench.py:27",
            "also_replaces": ["experiments/triangle_timepack.py:42"],
            "launches": main_launches["step_chain_best"],
            "max_abs_err": 0,
            # the bench's roofline leg: card-filling rows, lane 0 a start, s16x2
            "ms": min(k6_turns[rb_fill]["s16x2"]),
            "plain_ms": fill_plain_ms,
            "bound_ms": fill_bound[0],
            "bound_by": fill_bound[1],
            "library_ms": None,
            "forms": dict(k6_main_forms),
            "rows": rb_fill,
            "int32_ms": min(k6_turns[rb_fill]["int32"]),
            "int32_bound_ms": fill_bound[0],
            "rows512_ms": min(k6_turns[512]["s16x2"]),
            "rows512_int32_ms": min(k6_turns[512]["int32"]),
            "rows512_bound_ms": rows512_bound[0],
            "warps_gcups": {w: r for w, (r, _) in w_rates.items()},
            # the JAX microbench's inputs, int32 by the rule
            "jax_inputs_ms": k6[512, 128, False][0],
            "jax_inputs_plain_ms": k6[512, 128, False][1],
            "jax_inputs_bound_ms": k6[512, 128, False][2],
            "jax_inputs_lane0_read_ms": read_ms,
            "masked_ms": k6[248, 256, True][0],
            "masked_plain_ms": k6[248, 256, True][1],
            "masked_bound_ms": k6[248, 256, True][2],
        },
        {
            "name": "step_variant_best",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/step_variants.cu",
            "replaces": "experiments/packed_step_variants.py:18",
            "launches": main_launches["step_variant_best"],
            "max_abs_err": k7_max_err,
            "ms": min(k7["A"][0]["s16x2"]),
            "plain_ms": k7["A"][1],
            "bound_ms": k7_bound_ms,
            "bound_by": k7_bound_by,
            "library_ms": None,
            "forms": dict(k7_main_forms),
            "int32_ms": min(k7["A"][0]["int32"]),
            "int32_bound_ms": k7_bound_ms,
            "variant_ms": {v: min(t["s16x2"] if v != "C" else t["int32"]) for v, (t, _, _) in k7.items()},
            "variant_int32_ms": {v: min(t["int32"]) for v, (t, _, _) in k7.items()},
        },
        {
            "name": "max_cells_row",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/max_cells.cu",
            "replaces": "sparksmithwaterman_tpu/ops/longseq.py:61",
            "launches": main_launches["max_cells_row"],
            "max_abs_err": 0,
            "ms": k8_ms,
            "plain_ms": k8_plain_ms,
            "bound_ms": k8_bound_ms,
            "bound_by": k8_bound_by,
            "library_ms": None,
            "forms": dict(k8_main_forms),
            "kernel_ms": k8_kernel_ms,
            "finish_ms": k8_finish_ms,
            "int32_ms": k8_int32_ms,
            "long_ms": k8l_ms,
            "long_bound_ms": k8l_bound_ms,
            "long_segments": k8_segments,
            "long_unsplit_ms": k8l_unsplit_ms,
            "long_unsplit_bound_ms": k8l_bound_ms,
        },
        {
            "name": "fill_dirs",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/fill_dirs.cu",
            "replaces": "sparksmithwaterman_tpu/ops/recurrence.py:146",
            "launches": main_launches["fill_dirs"],
            "max_abs_err": 0,
            "ms": k9_ms,
            "plain_ms": k9_plain_ms,
            "bound_ms": k9_bound_ms,
            "bound_by": k9_bound_by,
            "library_ms": None,
            "full_ms": k9f_ms,
            "full_plain_ms": k9f_plain_ms,
            "full_bound_ms": k9f_bound_ms,
            "long_ms": k9l_ms,
            "long_bound_ms": k9l_bound_ms,
        },
        {
            "name": "trace_walk",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/trace_walk.cu",
            "replaces": "sparksmithwaterman_tpu/ops/device_traceback.py:41",
            "launches": main_launches["trace_walk"],
            "max_abs_err": 0,
            "ms": k10_ms,
            "plain_ms": k10_plain_ms,
            "bound_ms": k10_bound_ms,
            "bound_by": k10_bound_by,
            "library_ms": None,
            "full_ms": k10f_ms,
            "full_bound_ms": k10f_bound_ms,
            "long_ms": k10l_ms,
            "long_bound_ms": k10l_bound_ms,
        },
    ]
    fl_2k, fl_4k = fl["2k"], fl["4k"]
    fw_64, fw_long = fw["64"], fw["long"]
    kernels += [
        {
            "name": "fill_list",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/fill_walk.cu",
            "replaces": "sparksmithwaterman_tpu/ops/device_traceback.py:73",
            "launches": main_launches["fill_list"],
            "max_abs_err": 0,
            # 215 reads x a 2 kb ref broadcast, capacity 64: the kernel alone (entry_events)
            "ms": fl_2k[0]["public"][1],
            "plain_ms": fl_2k[1],
            "bound_ms": fl_2k[3][0],
            "bound_by": fl_2k[3][1],
            "library_ms": None,
            "wrapper_ms": fl_2k[0]["public"][0],
            "shared_ms": fl_2k[0]["shared"][1],
            "scratch_ms": fl_2k[0]["scratch"][1],
            "parent_ms": fl_2k[2],
            "peak_mb": fl_2k[4] / 1e6,
            "4k_ms": fl_4k[0]["public"][1],
            "4k_wrapper_ms": fl_4k[0]["public"][0],
            "4k_shared_ms": fl_4k[0]["shared"][1],
            "4k_scratch_ms": fl_4k[0]["scratch"][1],
            "4k_plain_ms": fl_4k[1],
            "4k_parent_ms": fl_4k[2],
            "4k_bound_ms": fl_4k[3][0],
        },
        {
            "name": "fill_walk",
            "route": "cuda",
            "source": "sparksmithwaterman_tpu_torch/csrc/fill_walk.cu",
            "replaces": "sparksmithwaterman_tpu/ops/longseq.py:364",
            "launches": main_launches["fill_walk"],
            "max_abs_err": 0,
            # 64 windows of 80-150 bp x 512, a cell each: the kernel alone (entry_events)
            "ms": fw_64[0]["public"][1],
            "plain_ms": fw_64[1],
            "bound_ms": fw_64[3][0],
            "bound_by": fw_64[3][1],
            "library_ms": None,
            "wrapper_ms": fw_64[0]["public"][0],
            "shared_ms": fw_64[0]["shared"][1],
            "scratch_ms": fw_64[0]["scratch"][1],
            "parent_ms": fw_64[2],
            "long_ms": fw_long[0]["public"][1],
            "long_wrapper_ms": fw_long[0]["public"][0],
            "long_plain_ms": fw_long[1],
            "long_parent_ms": fw_long[2],
            "long_bound_ms": fw_long[3][0],
        },
    ]
    # K8 (max_cells_row) at 4,096 lanes in both wide forms
    kernels[7].update(wide_max_abs_err=0, wide_ms=wide_t["K8"][0], wide_bound_ms=wide_t["K8"][1],
                      wide_forms=wide_main_forms["K8"], wide_int32_ms=wide_int32_ms["K8"],
                      wide_int32_bound_ms=wide_t["K8"][1])
    for entry, k in ((kernels[2], "K3"), (kernels[7], "K8")):  # the long-reference shapes, cut and whole
        cut_ms, whole_ms, bound_ms, _, cut_bps, whole_bps = long_t[k]
        entry.update(wide_long_ms=cut_ms, wide_long_bound_ms=bound_ms, wide_long_blocks_per_sm=cut_bps,
                     wide_long_unsplit_ms=whole_ms, wide_long_unsplit_bound_ms=bound_ms,
                     wide_long_unsplit_blocks_per_sm=whole_bps)
    for entry, k in zip(kernels, ("K1", "K2", "K3", "K4", "K5")):  # rows of 4,096 lanes, in stripes
        entry.update(wide_max_abs_err=wide_err[k], wide_ms=wide_t[k][0], wide_bound_ms=wide_t[k][1])
        if k in wide_int32_ms:  # K1's, K2's, K4's and K5's two wide forms, and their wide launches over the legs
            entry.update(wide_forms=wide_main_forms[k], wide_int32_ms=wide_int32_ms[k], wide_int32_bound_ms=wide_t[k][1])
    # K2 as the 6,000 bp corpus's traceback calls it, both wide forms
    kernels[1].update(wide_traceback_ms=k2m_ms["s16x2"], wide_traceback_int32_ms=k2m_ms["int32"])
    for entry in kernels:  # every share of a bound is at most 100%
        for key in [k for k in entry if k.endswith("bound_ms")]:
            ms = entry[key[: -len("bound_ms")] + "ms"]
            fail_unless(entry[key] <= ms, f"{entry['name']} ran in {ms} ms, under its {key} of {entry[key]} ms")
    fail_unless(sum(k2_main_forms.values()) == main_launches["argmax_lane"] and k2_main_forms["s16x2"] > 0,
                f"K2's forms {dict(k2_main_forms)} over the main-path legs: {main_launches['argmax_lane']} launches")
    print(f"[end] K2 launches over the main-path legs by form: {dict(k2_main_forms)}", flush=True)
    fail_unless(sum(k8_main_forms.values()) == main_launches["max_cells_row"],
                f"K8's forms {dict(k8_main_forms)} do not sum to its {main_launches['max_cells_row']} main-path launches")
    print(f"[end] K8 launches over the main-path legs by form: {dict(k8_main_forms)}", flush=True)
    for name, forms in (("step_chain_best", k6_main_forms), ("step_variant_best", k7_main_forms)):
        fail_unless(sum(forms.values()) == main_launches[name] and forms["s16x2"] > 0 and forms["int32"] > 0,
                    f"{name}'s forms {dict(forms)} over the main-path legs: {main_launches[name]} launches")
    print(f"[end] K6 and K7 launches over the main-path legs by form: {dict(k6_main_forms)}, {dict(k7_main_forms)}",
          flush=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sparksmithwaterman_tpu"))
    fail_unless(not leaked, f"the run loaded JAX or the JAX package: {leaked[:5]}")
    print("[end] seconds by phase: " + ", ".join(f"[{k}] {v:.1f}" for k, v in sorted(clock.seconds.items())),
          flush=True)
    total_s = time.perf_counter() - t_start
    if total_s > 540:
        slowest = max(clock.seconds, key=clock.seconds.get)
        print(f"[end] the run took {total_s:.1f} s, past 540 s: its longest phase is [{slowest}] "
              f"({clock.seconds[slowest]:.1f} s)", flush=True)
    print(f"[end] every phase passed in {total_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
