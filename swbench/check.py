"""The comparison that decides ``correct``: what the timed path wrote for a
sample of the window's input files, against the plain reference.

One number is compared, ``mismatches``, with the limit 0 (the
configurations state exact integer scores and every co-optimal site): the
answers of the sampled files (drawn from the seed among the files counted
in the window) that differ from the reference's, summed over four parts,
each also reported:

- ``reports_missing``: sampled files with no report, or one without a
  maximum score;
- ``winners_off``: references the report names as winners whose reference
  total is not its maximum score (and 1 where it names none or one the
  tree lacks); ``winner_total_gap`` is the largest such gap;
- ``sampled_refs_at_or_above_best``: references the report does not name
  whose reference total reaches its maximum score (a missed winner or a
  missed tie), among the winners' likeliest rivals (the LONGEST_REFS
  longest references, and up to SOURCE_REFS of those the reads came
  from) and RANDOM_REFS more at random, taken one of each list in turn
  and cut to the longest prefix of at most RIVAL_BP base pairs;
- ``report_lines_differing``: lines of the report, without its Execution
  Time line, that differ from the report the reference writes with its
  own sites of every read against every named winner.

The sample is CHECK_FILES files, or all the window's files where it
holds fewer; sample sizes belong to the check, not to a cell, so every
cell is checked alike.  RIVAL_BP bounds the reference's work on the
rivals at RIVAL_BP x a file's read bp: about 23 s a file of 512 short
reads on an H100, where the reference scores about 10.6 G cells/s.  It
is over (LONGEST_REFS + SOURCE_REFS + RANDOM_REFS) x the longest
reference of a RefSeq-shaped tree (72 x 49,092 bp at 256 Mbp), so it
cuts no sample there on any seed; on a tree of contigs of up to 1 Mb it
keeps a few of each kind.  The control (``swbench/control.py``) fails
the check through the last part.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List

import numpy as np

from swbench import gen
from swbench.reference import report as ref_report
from swbench.reference import smith_waterman as sw

LIMITS = {"mismatches": 0}
CHECK_FILES = 3
LONGEST_REFS = 8
SOURCE_REFS = 32
RANDOM_REFS = 32
RIVAL_BP = 1 << 22
PARTS = ("reports_missing", "winners_off", "sampled_refs_at_or_above_best", "report_lines_differing")


def parse_report(text: str):
    """(maximum score, [winner metadata]) of a report, or None."""
    lines = ref_report.stripped(text)
    best = None
    winners: List[str] = []
    for k, line in enumerate(lines):
        if line.startswith("Maximum alignment score = "):
            best = int(line.split("=")[1])
        elif best is not None and line == "Reference:" and k + 1 < len(lines):
            winners.append(lines[k + 1])
    return None if best is None else (best, winners)


def rivals(g: np.random.Generator, corpus: gen.Corpus, rf: gen.ReadsFile, known=()) -> List[int]:
    """The references scored against the file's reads besides ``known``,
    ascending: the LONGEST_REFS longest, up to SOURCE_REFS of the file's
    sources and up to RANDOM_REFS of the tree (the last two drawn from
    ``g`` in that order), taken one of each list in turn, and of those the
    longest prefix whose bp fit RIVAL_BP."""
    longest = np.argsort(-corpus.lens, kind="stable")[:LONGEST_REFS]
    sources = np.unique(rf.sources)
    from_sources = g.choice(sources, min(SOURCE_REFS, len(sources)), replace=False)
    at_random = g.choice(len(corpus.lens), min(RANDOM_REFS, len(corpus.lens)), replace=False)
    seen = {int(k) for k in known}
    order: List[int] = []
    for r in itertools.chain.from_iterable(itertools.zip_longest(longest, from_sources, at_random)):
        if r is not None and int(r) not in seen:
            seen.add(int(r))
            order.append(int(r))
    fit = int(np.searchsorted(np.cumsum(corpus.lens[order]), RIVAL_BP, side="right"))
    return sorted(order[:fit])


def check(corpus: gen.Corpus, files: List[gen.ReadsFile], reports: List[str], cfg: dict, seed: int, device,
          log=print) -> dict:
    """``mismatches`` and its parts, summed over the sampled files,
    ``winner_total_gap`` (the largest), and ``bad_files``: sampled files
    with any mismatch."""
    scoring = cfg["align"]["scoring"]
    scheme = (scoring["match"], scoring["mismatch"], scoring["gap"])
    gap_char = scoring.get("gap_char", "_")
    tie = scoring.get("tie_semantics", "serial")
    g = gen.rng(seed, 3)
    picked = sorted(g.choice(len(files), min(CHECK_FILES, len(files)), replace=False).tolist())
    by_name = {name: k for k, name in enumerate(corpus.names)}
    out = dict.fromkeys(PARTS + ("winner_total_gap", "bad_files"), 0)
    for f in picked:
        t0 = time.perf_counter()
        rf, path = files[f], reports[f]
        parsed = None
        if path and os.path.exists(path):
            with open(path) as fh:
                text = fh.read()
            parsed = parse_report(text)
        if parsed is None:
            out["reports_missing"] += 1
            out["bad_files"] += 1
            continue
        best, names = parsed
        winners = [by_name.get(n) for n in names]
        known = sorted({w for w in winners if w is not None}, key=lambda w: corpus.names[w])
        off = 0 if known and len(known) == len(winners) else 1
        gap = 0 if not off else max(1, best)
        # Each named winner: its sites and total.
        entries = []
        totals = {}
        for w in known:
            per_read_best, per_read = sw.read_sites(rf.reads, corpus.seq(w), scheme, device, gap_char, tie)
            totals[w] = int(per_read_best.sum())
            gap = max(gap, abs(totals[w] - best))
            off += int(totals[w] != best)
            entries.append((corpus.names[w], corpus.text(w), sw.winner_sites(per_read)))
        # Rivals: the longest, the reads' sources, a random sample.
        group = rivals(g, corpus, rf, known)
        t_rivals = time.perf_counter()
        rival_totals = sw.totals(rf.reads, [corpus.seq(r) for r in group], scheme, device)
        spent = f"{int(corpus.lens[group].sum())} bp in {time.perf_counter() - t_rivals:.2f} s"
        above = int((rival_totals >= best).sum())
        ref_best = max(totals.values()) if totals else 0
        expected = ref_report.report_lines(rf.texts, len(corpus.names), ref_best, entries)
        differing = ref_report.lines_differing(expected, ref_report.stripped(text))
        out["winner_total_gap"] = max(out["winner_total_gap"], gap)
        out["winners_off"] += off
        out["sampled_refs_at_or_above_best"] += above
        out["report_lines_differing"] += differing
        out["bad_files"] += int(off > 0 or above > 0 or differing > 0)
        log(f"check file {f + 1}: best {best}, winners {len(names)}, rivals {len(rival_totals)} (best rival "
            f"{int(rival_totals.max()) if len(rival_totals) else 0}), gap {gap}, above {above}, lines differing "
            f"{differing}, {time.perf_counter() - t0:.2f} s; rivals {spent}")
    out["mismatches"] = sum(out[k] for k in PARTS)
    out["files_checked"] = len(picked)
    return out
