"""Time each CUDA kernel of a checkout of the port, on one card, at the
shapes ``chip_smoke.py`` times them: one JSON line.

    python3 sparksmithwaterman_tpu_torch/utils/kernel_times.py [--only=KEY,...] [ROOT ...]

ROOT (default: this checkout) is a directory that holds
``sparksmithwaterman_tpu_torch/``; each ROOT runs in a process of its
own, in the order given, so an A/B of two trees on one card is one call
(``ROOT_A ROOT_B ROOT_B ROOT_A``).  Inputs come from a fixed numpy seed,
the same for every ROOT.  K1, K2, K4 and K5 are timed through their public
wrappers (the form the rule picks) and, where the tree has the private
entry that takes a form, in their int32 form too; K2 on 2,000 reads of
80-150 bp x one 2 kb ref (``K2``) and on 64 x one 131,072 bp ref
(``K2_131k``: 8 blocks of its s16x2 form, which it splits into column
segments; the int32 form runs one); K4 and K5 also with
the same reads at the width of their longest read (``K4_150``,
``K5_150``), as the batch backend passes a read group, and K5 with 16 of
them against one 131,072 bp ref (``K5_131k``: a launch of two blocks,
which K5 splits into column segments).  K3 runs 512 reads against one
segment of each of 32 refs (``K3``; ``K3_int32`` its int32 form where the
tree has the private entry) and 64 reads against the second quarter of
eight 131,072 bp refs (``K3_131k``: few blocks, which a tree with column
pieces cuts into them).  K8 (where the tree has it) lists
the cells at the bests of the 512 reads (at the width of their longest)
against one 2 kb ref (``K8``) and of 16 against the 131,072 bp ref (``K8_131k``, split into
column segments), the bests from K5, and on the reads K2 finds tied among
its 2,000 (``K8_tied``, as the traceback calls it).  ``fill_walk`` is one dispatch of
the windowed traceback (``longseq._fill_walk_known``: 64 reads of 80-150
bp in windows of 512 columns), which K9 and K10 run where the tree has
them (``K9``, ``K10``: each alone on those inputs); ``longref_traceback``
is the bench's ``longref_traceback_ms`` (median of 3).  ``full_fill``
and ``full_fill_4k`` time the full-fill branch's
``device_traceback.fill_and_trace`` on 215 of K2's reads x its 2 kb ref
and on 512 of them x a 4 kb ref, and ``fill_walk_long`` the windowed
branch's ``_fill_walk_known`` on 4 windows of 1,025-2,048 bp reads (K9
and K10 in one launch where the tree has ``fill_list`` and ``fill_walk``,
K9, the torch listing and K10 before).  K6 runs on the
JAX microbench's 512 x 128 rows (``K6``) and at the bench's roofline
shape (``K6_bench``: rows restarting at lane 0, the 16-bit form where the
tree has it), and K7 in variant A; each also in its int32 form where the
tree has the private entry that takes a form (``K6_int32``, which reads
no lane 0 as the public wrapper does, ``K6_bench_int32``, ``K7_int32``).
K1 and K4 at rows (reads) of 4,096 lanes, 64 reads of 500-4,096 bp x 64
refs, run striped (``K1_wide``, ``K4_wide``: the form the rule picks;
``K1_wide_int32``, ``K4_wide_int32`` where the tree has the striped
16-bit form); K5 on the same reads (``K5_wide``), K2 on 128 such reads
x one ref (``K2_wide``) and as the windowed traceback calls it on a file
of 120 short reads and 7 of 1,025-6,000 bp, all padded to 6,000, x one
3,258 bp ref (``K2_wide_tb``), and ``K5_wide_int32``, ``K2_wide_int32``,
``K2_wide_tb_int32`` where the tree has their wide 16-bit forms.  K3 on
64 reads of 500-3,276 bp in rows of 4,096 lanes x one segment of each of
64 refs, the longest read given where the tree's wrapper takes it
(``K3_wide``, and ``K3_wide_int32`` in its int32 form), and K8 on 128
reads of 500-4,096 bp x one 3 kb ref at their bests (``K8_wide``,
``K8_wide_int32``); the two cliffs of one long read: K3 on 256 reads of
80-150 bp and one of 2,000 bp packed as ``band_prepack`` packs them (rows
of 2,048 lanes) x one 1 Mb segment and 15 of 8 kb (``K3_wide_long``),
and K8 on one 2,048 bp read tied in a 131,072 bp ref that holds it twice
(``K8_wide_long``).  ``--only=KEY,...`` times those keys alone (their
inputs are drawn all the same, so every key keeps its inputs).
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

SEED = 20261017
PARAMS = (5, -3, -4)
# The bench's roofline leg (bench.ROOFLINE_WARPS, bench.ROOFLINE_STEPS),
# fixed here so that two trees time K6 at one shape.
K6_WARPS = 8
K6_STEPS = 81_920


def _times(root: str, only=None) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from sparksmithwaterman_tpu_torch import bench
    from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
    from sparksmithwaterman_tpu_torch.ops import _cuda, cuda_score, longseq
    from sparksmithwaterman_tpu_torch.ops.packing import pack_reads

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda")
    _cuda.lib()
    rng = np.random.default_rng(SEED)

    def seqs(lens):
        return [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(n))].tobytes().decode() for n in lens]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {}

    def put(key, fn, iters=10):
        """out[key] = ms(fn, iters), unless ``only`` leaves the key out."""
        if only is None or key in only:
            out[key] = ms(fn, iters)

    reads = seqs(rng.integers(80, 151, 512))
    refs = seqs(rng.integers(500, 4000, 256))
    packed, _ = pack_reads(reads, 256)
    flat, lens = encode_concat(refs)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    k1 = (up(packed), up(flat), up(lens.astype(np.int32)))
    offs_t = up(offs)
    put("K1", lambda: cuda_score.lane_best_packed_varlen(*k1, *PARAMS, offsets=offs_t))
    if hasattr(cuda_score, "_lane_best_packed_varlen"):
        put("K1_int32", lambda: cuda_score._lane_best_packed_varlen(*k1, *PARAMS, offsets=offs_t, form="int32"))
    # Rows of 4,096 lanes (64 reads of 500-4,096 bp) x 64 refs: striped.
    wide_reads = seqs(rng.integers(500, 4097, 64))
    wide = up(pack_reads(wide_reads, 4096)[0])
    offs_w = offs_t[:64]
    put("K1_wide", lambda: cuda_score.lane_best_packed_varlen(wide, k1[1], k1[2][:64], *PARAMS, offsets=offs_w), 3)
    if hasattr(cuda_score, "k1k4_form"):  # a tree with K1's and K4's striped 16-bit form
        put("K1_wide_int32", lambda: cuda_score._lane_best_packed_varlen(wide, k1[1], k1[2][:64], *PARAMS,
                                                                              offsets=offs_w, form="int32"), 3)
    reads_2 = up(encode_batch(seqs(rng.integers(80, 151, 2000)), 152, READ_PAD))
    ref_2_seq = seqs([2000])[0]
    ref_2 = up(encode_batch([ref_2_seq], 2000, REF_PAD))
    put("K2", lambda: cuda_score.argmax_lane(reads_2, ref_2, *PARAMS))
    refs_3 = refs[:32]
    flat_3, lens_3 = encode_concat(refs_3)
    offs_3 = np.concatenate(([0], np.cumsum(lens_3)[:-1])).astype(np.int64)
    k3 = (up(packed), up(flat_3), up(offs_3), up(lens_3.astype(np.int32)), up(lens_3.astype(np.int32)),
          up(rng.integers(0, 120, size=(32,) + packed.shape).astype(np.int32)))
    cols_3 = int(lens_3.sum())  # given, as the shard_seq ring gives it
    put("K3", lambda: cuda_score.band_lane_best(*k3, *PARAMS, carry_cols=cols_3))
    if hasattr(cuda_score, "_band_lane_best"):
        put("K3_int32", lambda: cuda_score._band_lane_best(*k3, *PARAMS, carry_cols=cols_3, form="int32"))
    grid = (up(encode_batch(reads, 256, READ_PAD)), up(encode_batch(refs[:64], 4000, REF_PAD)))
    put("K4", lambda: cuda_score.score_grid_diag(*grid, *PARAMS))
    grid_150 = (up(encode_batch(reads, max(map(len, reads)), READ_PAD)), grid[1])
    put("K4_150", lambda: cuda_score.score_grid_diag(*grid_150, *PARAMS))
    if hasattr(cuda_score, "_score_grid_diag"):
        put("K4_int32", lambda: cuda_score._score_grid_diag(*grid, *PARAMS, form="int32"))
        put("K4_150_int32", lambda: cuda_score._score_grid_diag(*grid_150, *PARAMS, form="int32"))
    grid_wide = (up(encode_batch(wide_reads, 4096, READ_PAD)), grid[1])
    put("K4_wide", lambda: cuda_score.score_grid_diag(*grid_wide, *PARAMS), 3)
    if hasattr(cuda_score, "k1k4_form"):
        put("K4_wide_int32", lambda: cuda_score._score_grid_diag(*grid_wide, *PARAMS, form="int32"), 3)
    # K5 on the same grid, K2 on 128 reads of 500-4,096 bp (those 64 and 64
    # more from a generator of their own, so the later keys' inputs stay as
    # they were) x one ref.
    put("K5_wide", lambda: cuda_score.score_grid_row(*grid_wide, *PARAMS), 3)
    rng_2w = np.random.default_rng(SEED + 1)
    more = [np.frombuffer(b"ACGT", np.uint8)[rng_2w.integers(0, 4, int(n))].tobytes().decode()
            for n in rng_2w.integers(500, 4097, 64)]
    args_2w = (up(encode_batch(wide_reads + more, 4096, READ_PAD)), up(encode_batch(refs[:1], len(refs[0]), REF_PAD)))
    put("K2_wide", lambda: cuda_score.argmax_lane(*args_2w, *PARAMS), 3)
    # K2 as the windowed traceback calls it on a file with a few long
    # reads: 120 reads of 80-150 bp and 7 of 1,025-6,000 bp, every read
    # padded to the longest, x one 3,258 bp ref.
    tb_reads = [np.frombuffer(b"ACGT", np.uint8)[rng_2w.integers(0, 4, int(n))].tobytes().decode()
                for n in [*rng_2w.integers(80, 151, 120), 1025, 1100, 1500, 2048, 3000, 4096, 6000]]
    tb_ref = np.frombuffer(b"ACGT", np.uint8)[rng_2w.integers(0, 4, 3258)].tobytes().decode()
    args_tb = (up(encode_batch(tb_reads, 6000, READ_PAD)), up(encode_batch([tb_ref], 3258, REF_PAD)))
    put("K2_wide_tb", lambda: cuda_score.argmax_lane(*args_tb, *PARAMS), 3)
    if hasattr(cuda_score, "k5_form"):  # a tree with K5's and K2's wide 16-bit forms
        put("K5_wide_int32", lambda: cuda_score._score_grid_row(*grid_wide, *PARAMS, form="int32"), 3)
        put("K2_wide_int32", lambda: cuda_score._argmax_lane(*args_2w, *PARAMS, form="int32"), 3)
        put("K2_wide_tb_int32", lambda: cuda_score._argmax_lane(*args_tb, *PARAMS, form="int32"), 3)
    put("K5", lambda: cuda_score.score_grid_row(*grid, *PARAMS))
    put("K5_150", lambda: cuda_score.score_grid_row(*grid_150, *PARAMS))
    grid_131k = (up(encode_batch(reads[:16], 152, READ_PAD)), up(encode_batch(seqs([131_072]), 131_072, REF_PAD)))
    put("K5_131k", lambda: cuda_score.score_grid_row(*grid_131k, *PARAMS), 3)
    if hasattr(cuda_score, "_score_grid_row"):
        for key, args, iters in (("K5", grid, 10), ("K5_150", grid_150, 10), ("K5_131k", grid_131k, 3)):
            put(f"{key}_int32", lambda: cuda_score._score_grid_row(*args, *PARAMS, form="int32"), iters)
    if hasattr(cuda_score, "max_cells_row"):
        for key, reads_8, ref_8, iters in (("K8", grid_150[0], ref_2, 10), ("K8_131k", grid_131k[0], grid_131k[1], 3)):
            best_8 = cuda_score.score_grid_row(reads_8, ref_8, *PARAMS)[:, 0].contiguous()
            put(key, lambda: cuda_score.max_cells_row(reads_8, ref_8[0], best_8, *PARAMS, 1024), iters)
    chain = up(np.random.default_rng(0).integers(2, 6, size=(512, 128)).astype(np.int32))
    put("K6", lambda: cuda_score.step_chain_best(chain, steps=131_072, unroll=64), 5)
    if hasattr(cuda_score, "_step_chain_best"):  # the int32 form given: no lane-0 read
        put("K6_int32", lambda: cuda_score._step_chain_best(chain, steps=131_072, unroll=64, form="int32"), 5)
    # The bench's roofline leg: 8 x SMs x K6_WARPS rows of 128 lanes, lane 0
    # of every row a start, K6_STEPS steps.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chain_b = np.random.default_rng(0).integers(2, 6, size=(8 * sms * K6_WARPS, 128)).astype(np.int32)
    chain_b[:, 0] |= 256
    chain_b = up(chain_b)
    put("K6_bench", lambda: cuda_score.step_chain_best(chain_b, steps=K6_STEPS, unroll=64), 5)
    if hasattr(cuda_score, "_step_chain_best"):
        put("K6_bench_int32", lambda: cuda_score._step_chain_best(chain_b, steps=K6_STEPS, unroll=64,
                                                                       form="int32"), 5)
    packed_7 = np.random.default_rng(0).integers(65, 85, size=(248, 256)).astype(np.int32)
    packed_7[:, 0] |= 256
    packed_7, refs_7 = up(packed_7), up(encode_batch(seqs([1024] * 64), 1024, REF_PAD))
    put("K7", lambda: cuda_score.step_variant_best(packed_7, refs_7, variant="A"))
    if hasattr(cuda_score, "_step_variant_best"):
        put("K7_int32", lambda: cuda_score._step_variant_best(packed_7, refs_7, variant="A", form="int32"))
    # One dispatch of the windowed traceback: 64 reads of 80-150 bp, each in
    # a window of 512 columns ending at its copy in a 2 kb ref (REF_PAD on the
    # left), walked from its last row.
    ref_w = seqs([2000])[0]
    lens_w = rng.integers(80, 151, 64)
    ends_w = rng.integers(lens_w, 2001)
    wins = np.full((64, 512), REF_PAD, np.uint8)
    for t, e in enumerate(ends_w):
        piece = ref_w[max(0, e - 402) : e]  # longseq.window_width(150, ...) columns
        wins[t, 512 - len(piece) :] = encode_batch([piece], len(piece), REF_PAD)[0]
    m_w = int(lens_w.max())
    args_w = (up(encode_batch([ref_w[e - n : e] for e, n in zip(ends_w, lens_w)], m_w, READ_PAD)), up(wins),
              up(np.stack([lens_w - 1, np.full(64, 511)], 1).astype(np.int32)))
    put("fill_walk", lambda: longseq._fill_walk_known(*args_w, *PARAMS, cap=m_w + 512, tie_semantics="serial"), 3)
    if hasattr(cuda_score, "fill_dirs"):
        put("K9", lambda: cuda_score.fill_dirs(*args_w[:2], *PARAMS, tie_semantics="serial", want_h=False))
        dirs_w = cuda_score.fill_dirs(*args_w[:2], *PARAMS, tie_semantics="serial", want_h=False)[1]
        put("K10", lambda: cuda_score.trace_walk(dirs_w, args_w[2][:, None, :], m_w + 512))
    # Drawn last, so that the inputs above stay those of earlier trees' runs.
    reads_2l = up(encode_batch(seqs(rng.integers(80, 151, 64)), 152, READ_PAD))
    ref_2l = up(encode_batch(seqs([131_072]), 131_072, REF_PAD))
    put("K2_131k", lambda: cuda_score.argmax_lane(reads_2l, ref_2l, *PARAMS), 3)
    if hasattr(cuda_score, "_argmax_lane"):
        put("K2_int32", lambda: cuda_score._argmax_lane(reads_2, ref_2, *PARAMS, form="int32"))
        put("K2_131k_int32", lambda: cuda_score._argmax_lane(reads_2l, ref_2l, *PARAMS, form="int32"), 3)
    # K8 on the reads K2 finds tied inside a DP row there, as the traceback
    # calls it, at each read's best.
    best_t, _, count_t = (t[:, 0] for t in cuda_score.argmax_lane(reads_2, ref_2, *PARAMS))
    top = best_t.amax(dim=1)
    tied = (((best_t == top[:, None]) & (count_t != 1)).any(dim=1) & (top > 0)).nonzero()[:, 0]
    reads_t, top_t = reads_2[tied].contiguous(), top[tied].to(torch.int32).contiguous()
    put("K8_tied", lambda: cuda_score.max_cells_row(reads_t, ref_2[0], top_t, *PARAMS, 1024))
    # The full-fill branch's fill_and_trace (capacity 64, the branch's cap)
    # on 215 of the 2,000 reads x the 2 kb ref padded to 2,048 and on 512
    # reads x a 4 kb ref, and the windowed branch's _fill_walk_known on 4
    # windows of 1,025-2,048 bp reads (window_width(2,048) columns, REF_PAD
    # on the left, each walked from its read's last row): both names stand in
    # the trees that have K9 and K10.
    from sparksmithwaterman_tpu_torch.ops import device_traceback

    cap_f = device_traceback.path_cap(152, 5, -4)
    ref_f = up(encode_batch([ref_2_seq], 2048, REF_PAD))
    put("full_fill", lambda: device_traceback.fill_and_trace(reads_2[:215], ref_f, *PARAMS, capacity=64, cap=cap_f,
                                                                   tie_semantics="serial"), 5)
    ref_4 = up(encode_batch(seqs([4096]), 4096, REF_PAD))
    put("full_fill_4k", lambda: device_traceback.fill_and_trace(reads_2[:512], ref_4, *PARAMS, capacity=64,
                                                                      cap=cap_f, tie_semantics="serial"), 3)
    ref_l = seqs([8000])[0]
    lens_l = np.array([1025, 1300, 1777, 2048])
    ends_l = rng.integers(lens_l, 8001)
    w_l = longseq.window_width(2048, 8000, *PARAMS)
    w_pad = -(-w_l // 256) * 256
    wins_l = np.full((4, w_pad), REF_PAD, np.uint8)
    for t, e in enumerate(ends_l):
        piece = ref_l[max(0, e - w_l) : e]
        wins_l[t, w_pad - len(piece) :] = encode_batch([piece], len(piece), REF_PAD)[0]
    args_l = (up(encode_batch([ref_l[e - n : e] for e, n in zip(ends_l, lens_l)], 2048, READ_PAD)), up(wins_l),
              up(np.stack([lens_l - 1, np.full(4, w_pad - 1)], 1).astype(np.int32)))
    put("fill_walk_long", lambda: longseq._fill_walk_known(*args_l, *PARAMS, cap=2048 + w_pad,
                                                                tie_semantics="serial"), 3)
    if only is None or "longref_traceback" in only:
        out["longref_traceback"] = bench.bench_longref(device=dev)[0]["traceback_ms"][0]
    # K3 on a quarter of eight 131,072 bp refs (a segment of the shard_seq
    # ring on four entries), 64 reads, a random left column: few blocks, so
    # the tree that has column pieces cuts each segment into them; the
    # columns given, as the ring gives them.
    reads_3q = seqs(rng.integers(80, 151, 64))
    packed_3q = pack_reads(reads_3q, 256)[0]
    flat_3q = encode_concat(seqs([131_072] * 8))[0]
    quarter = np.full(8, 32_768, np.int32)
    k3q = (up(packed_3q), up(flat_3q), up(np.arange(8, dtype=np.int64) * 131_072 + 32_768), up(quarter), up(quarter),
           up(rng.integers(0, 120, size=(8,) + packed_3q.shape).astype(np.int32)))
    put("K3_131k", lambda: cuda_score.band_lane_best(*k3q, *PARAMS, carry_cols=8 * 32_768), 5)
    # K3 and K8 past 1,024 lanes, from a generator of their own.  K3: 64
    # reads of 500-3,276 bp in rows of 4,096 lanes x one segment of each of
    # 64 refs, a random left column, the longest read given where the tree
    # takes it; K8: [14]'s 128 reads of 500-4,096 bp x one ref, at their
    # bests.  The cliffs: K3 on 256 reads of 80-150 bp and one of 2,000 bp,
    # packed as band_prepack packs them (rows of 2,048 lanes), x one 1 Mb
    # segment and 15 of 8 kb; K8 on one 2,048 bp read x a 131,072 bp ref
    # that holds it twice (a tie inside its last row).
    rng_l = np.random.default_rng(SEED + 3)

    def seqs_l(lens):
        return [np.frombuffer(b"ACGT", np.uint8)[rng_l.integers(0, 4, int(n))].tobytes().decode() for n in lens]

    takes_longest = "longest" in inspect.signature(cuda_score.band_lane_best).parameters

    def k3_args(reads_k, m, refs_k):
        packed_k = pack_reads(reads_k, m)[0]
        flat_k, lens_k = encode_concat(refs_k)
        offs_k = np.concatenate(([0], np.cumsum(lens_k)[:-1])).astype(np.int64)
        lens_k = up(lens_k.astype(np.int32))
        bnd_k = up(rng_l.integers(0, 120, size=(len(refs_k),) + packed_k.shape).astype(np.int32))
        kw = {"carry_cols": int(lens_k.sum())}
        if takes_longest:
            kw["longest"] = max(map(len, reads_k))
        return (up(packed_k), up(flat_k), up(offs_k), lens_k, lens_k, bnd_k), kw

    k3w, k3w_kw = k3_args(seqs_l(rng_l.integers(500, 3277, 64)), 4096, seqs_l(rng_l.integers(500, 4001, 64)))
    put("K3_wide", lambda: cuda_score.band_lane_best(*k3w, *PARAMS, **k3w_kw), 3)
    put("K3_wide_int32", lambda: cuda_score._band_lane_best(*k3w, *PARAMS, carry_cols=k3w_kw["carry_cols"],
                                                            form="int32"), 3)
    reads_8w = up(encode_batch(seqs_l(rng_l.integers(500, 4097, 128)), 4096, READ_PAD))
    ref_8w = up(encode_batch(seqs_l([3000]), 3000, REF_PAD))
    best_8w = cuda_score.score_grid_row(reads_8w, ref_8w, *PARAMS)[:, 0].contiguous()
    put("K8_wide", lambda: cuda_score.max_cells_row(reads_8w, ref_8w[0], best_8w, *PARAMS, 64), 3)
    put("K8_wide_int32", lambda: cuda_score._max_cells_row(reads_8w, ref_8w[0], best_8w, *PARAMS, 64, form="int32"), 3)
    k3l, k3l_kw = k3_args(seqs_l(rng_l.integers(80, 151, 256)) + seqs_l([2000]), 2048,
                          seqs_l([1_000_000] + [8_000] * 15))
    put("K3_wide_long", lambda: cuda_score.band_lane_best(*k3l, *PARAMS, **k3l_kw), 1)
    read_8l = seqs_l([2048])[0]
    ref_8l = seqs_l([131_072])[0]
    ref_8l = ref_8l[:10_000] + read_8l + ref_8l[12_048:100_000] + read_8l + ref_8l[102_048:]
    args_8l = (up(encode_batch([read_8l], 2048, READ_PAD)), up(encode_batch([ref_8l], 131_072, REF_PAD)))
    best_8l = cuda_score.score_grid_row(*args_8l, *PARAMS)[:, 0].contiguous()
    put("K8_wide_long", lambda: cuda_score.max_cells_row(args_8l[0], args_8l[1][0], best_8l, *PARAMS, 64), 1)
    return out, _registers(_cuda.build_info["log"])


def _registers(log: str) -> dict:
    """{kernel and template arguments: "<registers>r[+<spill bytes>s]"}
    from nvcc's -Xptxas -v log (empty when the library came from the
    cache); the key drops the mangled name's per-file namespace, so two
    trees' keys match."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            mangled = line.split("'")[1]
            head = mangled[: mangled.index("_kernel") + len("_kernel")]
            n = next(n for n in range(len("_kernel"), len(head) + 1) if head[:-n].endswith(str(n)))
            name, spill = mangled[len(head) - n :], 0
        elif name and "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs}r" + (f"+{spill}s" if spill else "")
            name = None
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    keys = [a for a in argv if a.startswith("--only=")]
    only = set(keys[-1][len("--only="):].split(",")) if keys else None
    roots = [a for a in argv if a not in keys]
    roots = roots or [os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
    if len(roots) == 1:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[:1]
        times, registers = _times(roots[0], only)
        print(json.dumps({"root": roots[0], "card": card, "ms": times, "ptxas": registers}), flush=True)
        return 0
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), *keys, root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
