"""The inputs of the present cells and the check's sample of rivals: the
same, byte for byte, as the harness made them before length tables,
reads drawn by bases and the bp budget on the rivals; the budget cuts
only on a tree of references longer than RefSeq's."""

import hashlib
import json
import os

import numpy as np
import pytest

from swbench import check, gen
from swbench.tests.conftest import REPO

CELLS = {"refseq_rna": ["short_reads", "long_reads"], "refseq_rna_4gpu": ["short_reads_1k"]}
SEEDS = (3141592653, 27)
# SHA-256 of each tree (lengths, codes and its files), of input files 0-2
# of each mix (bytes and sources) and of the check's sample of files and
# rivals over them, taken with the harness before those three changes.
DIGESTS = {
    "refseq_rna/3141592653/tree": "0c85b304882de95ae55900b071362e93b7f36cada138e18b3b7403fe1685d434",
    "refseq_rna/3141592653/short_reads/files": "d2943da16d83042e78c36c3478f9e51dc09839c561a002cbb00d93ac9bd278ee",
    "refseq_rna/3141592653/short_reads/rivals": "6046a0949e14e17e8325a1c7f6e4514a8f0a17981e8e04f1f781af2d41d07288",
    "refseq_rna/3141592653/long_reads/files": "d0190fd9082bb604afa06842ab00ea971f1673dc32fe22bae1c74a13d27a7861",
    "refseq_rna/3141592653/long_reads/rivals": "73e5bf404322ff4002f9467a46aaede37e57384055f42b5b314a05f54fdc9de1",
    "refseq_rna/27/tree": "33abff761bffeae648a4509424999ffccccce80abc30fc6fb43892cec035fd5b",
    "refseq_rna/27/short_reads/files": "2130320ee797e30dac573ed2387b6568dd6a205f3d72cfb1835f48db0ac1c498",
    "refseq_rna/27/short_reads/rivals": "567070caa603f3428fb181f8628f364b6ea210f9854a97ec2eb60110141a5ea3",
    "refseq_rna/27/long_reads/files": "2a7c8a005325363242bd8e3ab0d37f9e0d7eb1b89fcf2e607d5d0a7447ac122c",
    "refseq_rna/27/long_reads/rivals": "c53ccf088f601d86dfab1ade1fe60316976cde2cd067daf7463350271b04292e",
    "refseq_rna_4gpu/3141592653/tree": "0875b73015e178d7acc7a294084a217d923d7b8719f2977fdf9f8efa6ce2b59b",
    "refseq_rna_4gpu/3141592653/short_reads_1k/files":
        "79d9809bb2fcef48d8f666081f9286a3068ca9b841078ba0caea907c6b93fa59",
    "refseq_rna_4gpu/3141592653/short_reads_1k/rivals":
        "4d07d9d64d4c7e74914a276f70ccfb968e78221bb6826793e63a35e79e371ae3",
    "refseq_rna_4gpu/27/tree": "9078d6fd8c42ce500744620497b238aa05271ae46d8c7c38cead9f059a982863",
    "refseq_rna_4gpu/27/short_reads_1k/files": "ac83c2f6ec91ee84137d86e37e6ecea696f35395fcb6e203fbe0539593f88784",
    "refseq_rna_4gpu/27/short_reads_1k/rivals": "9dec5024e25537f568125bdb216524ccdd23173cb93d2b5c3b062d03a4aca574",
}


def _load(kind, name):
    with open(os.path.join(REPO, "swbench", kind, f"{name}.json")) as f:
        return json.load(f)


def _sample_digest(g, corpus, files):
    """The check's draws over ``files``: the picked files, then each one's
    rivals (the longest and the drawn, as one sorted set)."""
    picked = sorted(g.choice(len(files), min(check.CHECK_FILES, len(files)), replace=False).tolist())
    h = hashlib.sha256(np.asarray(picked, np.int64).tobytes())
    for f in picked:
        h.update(np.asarray(check.rivals(g, corpus, files[f]), np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config, seed", [(c, s) for c in CELLS for s in SEEDS])
def test_the_present_cells_inputs_and_sample_are_unchanged(tmp_path, config, seed):
    corpus = gen.make_corpus(_load("configs", config), seed, str(tmp_path / "refs"))
    h = hashlib.sha256(corpus.lens.astype(np.int64).tobytes())
    h.update(corpus.codes.tobytes())
    for path in corpus.files:
        with open(path, "rb") as f:
            h.update(f.read())
    assert h.hexdigest() == DIGESTS[f"{config}/{seed}/tree"]
    for name in CELLS[config]:
        files = gen.make_reads_files(corpus, _load("traffic", name), seed, str(tmp_path / "in" / name), 0, 3)
        h = hashlib.sha256()
        for rf in files:
            with open(rf.path, "rb") as f:
                h.update(f.read())
            h.update(np.asarray(rf.sources, np.int64).tobytes())
        assert h.hexdigest() == DIGESTS[f"{config}/{seed}/{name}/files"]
        assert _sample_digest(gen.rng(seed, 3), corpus, files) == DIGESTS[f"{config}/{seed}/{name}/rivals"]


def _uncut_rivals(g, corpus, rf):
    """The rivals as drawn before the budget, ascending: the longest, up to
    SOURCE_REFS sources and RANDOM_REFS at random, all kept."""
    longest = np.argsort(-corpus.lens, kind="stable")[:check.LONGEST_REFS].tolist()
    sources = np.unique(rf.sources)
    drawn = g.choice(sources, min(check.SOURCE_REFS, len(sources)), replace=False).tolist()
    drawn += g.choice(len(corpus.lens), min(check.RANDOM_REFS, len(corpus.lens)), replace=False).tolist()
    return sorted(set(longest) | set(drawn))


@pytest.mark.parametrize("config", list(CELLS))
def test_the_budget_cuts_no_rival_of_the_present_configs(tmp_path, config):
    """The LONGEST_REFS longest and as many more of at most the longest
    length fit RIVAL_BP, so no seed's sample is cut; over 50 seeds, with
    each seed's order of the configuration's lengths and each mix's
    reads, every drawn rival is kept."""
    cfg = _load("configs", config)
    lengths = gen.reference_lengths(cfg)
    most = check.SOURCE_REFS + check.RANDOM_REFS
    assert lengths[-check.LONGEST_REFS:].sum() + most * lengths[-1] <= check.RIVAL_BP == 4_194_304
    for seed in range(2**31, 2**31 + 50):
        lens = gen.rng(seed, 1).permutation(lengths)
        offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
        corpus = gen.Corpus(np.zeros(int(lens.sum()), np.uint8), offsets, lens, [], [])
        for name in CELLS[config]:
            rf = gen.make_reads_files(corpus, _load("traffic", name), seed, str(tmp_path / name), 0, 1)[0]
            assert check.rivals(gen.rng(seed, 3), corpus, rf) == _uncut_rivals(gen.rng(seed, 3), corpus, rf)


def test_the_named_winners_are_no_rivals():
    lens = np.full(100, 1000, np.int64)
    corpus = gen.Corpus(np.zeros(0, np.uint8), np.arange(0, 100_000, 1000), lens, [], [])
    rf = gen.ReadsFile("", [], [], np.arange(10))
    every = check.rivals(gen.rng(4, 3), corpus, rf)
    assert check.rivals(gen.rng(4, 3), corpus, rf, known=every[:3]) == every[3:]


def test_the_budget_takes_each_kind_in_turn_on_a_tree_of_1_mb_references():
    """On references of up to 1 Mb the sample is the longest prefix,
    within RIVAL_BP, of the longest, the sources and the random ones
    taken one of each in turn: the longest reference first, and every
    kind in it."""
    lens = np.array([1_048_576] * 2 + [1_000_000] * 6 + [300_000] * 40 + [9_000] * 40, np.int64)
    corpus = gen.Corpus(np.zeros(0, np.uint8), np.concatenate(([0], np.cumsum(lens)[:-1])), lens, [], [])
    rf = gen.ReadsFile("", [], [], np.arange(8, 48))
    for seed in range(20):
        kept = check.rivals(gen.rng(seed, 3), corpus, rf)
        g = gen.rng(seed, 3)
        sources = g.choice(np.arange(8, 48), 32, replace=False).tolist()
        at_random = g.choice(len(lens), 32, replace=False).tolist()
        turns = [[k, sources[k], at_random[k]] for k in range(8)]
        turns += [[sources[k], at_random[k]] for k in range(8, 32)]
        order = []
        for r in sum(turns, []):
            if r not in order:
                order.append(r)
        n = len(kept)
        assert sorted(order[:n]) == kept
        assert lens[kept].sum() <= check.RIVAL_BP < lens[order[: n + 1]].sum()
        assert {0, sources[0], at_random[0]} <= set(kept)
        assert 3 <= n < len(_uncut_rivals(gen.rng(seed, 3), corpus, rf))
