"""The unpacked mesh functions, ``ShardedBackend``'s unpacked and row
paths, and ``swtorch scaling`` against the JAX package on the CPU.  A port
mesh of N CPU entries stands where the JAX tests use N of their 8 virtual
devices."""

import json

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.models.aligner import SerialBackend
from sparksmithwaterman_tpu.parallel import ShardedBackend as JaxShardedBackend
from sparksmithwaterman_tpu.parallel import build_mesh as jax_build_mesh
from sparksmithwaterman_tpu.parallel import sharded_score_grid as jax_sharded_score_grid
from sparksmithwaterman_tpu.parallel import sharded_totals as jax_sharded_totals
from sparksmithwaterman_tpu_torch.cli import main as torch_cli
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.metrics.scaling import measure_scaling
from sparksmithwaterman_tpu_torch.parallel import ShardedBackend, build_mesh, sharded_score_grid, sharded_totals

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))
MESHES = [(8, 1), (1, 8), (4, 2), (2, 4)]


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


def _cpu_mesh(shape):
    return build_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _grid(seed, r=16, c=8):
    """R reads and C refs, divisible by every test mesh's axes (as the JAX
    functions need), with an empty read and an empty ref."""
    rng = np.random.default_rng(seed)
    reads = _seqs(rng, rng.integers(1, 24, r - 1)) + [""]
    refs = _seqs(rng, rng.integers(4, 60, c - 1)) + [""]
    return encode_batch(reads, 24, READ_PAD), encode_batch(refs, 60, REF_PAD)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_sharded_functions_match_jax(shape):
    """Both kernels on the port's mesh against the JAX lax path on its
    virtual devices, and a ragged grid (13 x 7, which the JAX functions
    refuse) against the JAX grid of its padded copy."""
    reads_enc, refs_enc = _grid(sum(shape))
    jax_mesh = jax_build_mesh(shape)
    want = np.asarray(jax_sharded_score_grid(reads_enc, refs_enc, *PARAMS, mesh=jax_mesh))
    want_totals = np.asarray(jax_sharded_totals(reads_enc, refs_enc, *PARAMS, mesh=jax_mesh))
    mesh = _cpu_mesh(shape)
    for kernel in ("diag", "row"):
        got = sharded_score_grid(reads_enc, refs_enc, *PARAMS, mesh=mesh, kernel=kernel)
        np.testing.assert_array_equal(got.numpy(), want)
        totals = sharded_totals(reads_enc, refs_enc, *PARAMS, mesh=mesh, kernel=kernel)
        assert totals.dtype == torch.int64
        np.testing.assert_array_equal(totals.numpy(), want_totals)
    ragged = sharded_score_grid(reads_enc[:13], refs_enc[:7], *PARAMS, mesh=mesh)
    np.testing.assert_array_equal(ragged.numpy(), want[:13, :7])
    np.testing.assert_array_equal(
        sharded_totals(reads_enc[:13], refs_enc[:7], *PARAMS, mesh=mesh).numpy(), want[:13, :7].sum(axis=0)
    )


def test_sharded_score_grid_matches_jax_kernel_interpret():
    """Against the JAX wavefront kernel per shard (``kernel_params``, in
    interpret mode) on a (4, 2) mesh."""
    reads_enc, refs_enc = _grid(5)
    want = jax_sharded_score_grid(
        reads_enc, refs_enc, *PARAMS, mesh=jax_build_mesh((4, 2)), kernel_params=PARAMS + (8,), interpret=True
    )
    got = sharded_score_grid(reads_enc, refs_enc, *PARAMS, mesh=_cpu_mesh((4, 2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_functions_reject_bad_arguments():
    reads_enc, refs_enc = _grid(3)
    with pytest.raises(ValueError):
        sharded_totals(reads_enc, refs_enc, *PARAMS, mesh=_cpu_mesh((2, 2)), kernel="prefix")
    seq_mesh = build_mesh((2,), axis_names=("seq",), devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        sharded_score_grid(reads_enc, refs_enc, *PARAMS, mesh=seq_mesh)


def _config(cls, **kw):
    return cls(ref_dir=".", in_dir=".", out_dir=".", read_bucket=8, ref_bucket=8, **kw)


@pytest.mark.parametrize(
    "kw, shape",
    [(dict(pack_reads=False, strategy="shard_refs"), (4, 2)), (dict(kernel="row", strategy="shard_reads"), (2, 4))],
    ids=["unpacked", "row"],
)
def test_sharded_backend_matches_jax(kw, shape):
    rng = np.random.default_rng(shape[0])
    reads = _seqs(rng, rng.integers(1, 60, 13)) + [""]
    refs = _seqs(rng, rng.integers(0, 200, 9))
    refs[4] = refs[2]
    backend = ShardedBackend(_config(AlignConfig, **kw), _cpu_mesh(shape))
    jax_backend = JaxShardedBackend(_config(JaxAlignConfig, **kw), jax_build_mesh(shape))
    want = jax_backend.totals(reads, refs)
    np.testing.assert_array_equal(want, SerialBackend().totals(reads, refs))
    np.testing.assert_array_equal(backend.totals(reads, refs), want)
    assert backend.best_of(reads, refs) == jax_backend.best_of(reads, refs)


def _check_rows(rows, counts):
    assert [r["devices"] for r in rows] == counts
    assert set(rows[0]) == {"devices", "seconds", "gcups", "efficiency"}
    assert rows[0]["efficiency"] == 1.0
    assert all(r["seconds"] > 0 for r in rows)


def test_measure_scaling_refs_axis():
    """Rows on 1, 2 and 4 entries; the sweep itself raises if the totals of
    two mesh sizes differ.  A count above the devices is skipped, one that
    does not divide num_refs raises."""
    rows = measure_scaling([1, 2, 4, 16], num_reads=8, read_len=16, num_refs=8, ref_len=64, iters=1,
                           devices=["cpu"] * 4)
    _check_rows(rows, [1, 2, 4])
    with pytest.raises(ValueError):
        measure_scaling([3], num_reads=4, read_len=8, num_refs=8, ref_len=16, iters=1, devices=["cpu"] * 4)


def test_measure_scaling_seq_axis():
    rows = measure_scaling([1, 2, 8], num_reads=4, read_len=16, ref_len=128, iters=1, axis="seq",
                           devices=["cpu"] * 8)
    _check_rows(rows, [1, 2, 8])


@pytest.mark.parametrize("axis", ["refs", "seq"])
def test_cli_scaling_prints_json(capsys, axis):
    argv = ["scaling", "--axis", axis, "--device", "cpu", "--devices", "1",
            "--num-reads", "4", "--read-len", "16", "--num-refs", "4", "--ref-len", "64"]
    assert torch_cli(argv) == 0
    rows = json.loads(capsys.readouterr().out)
    _check_rows(rows, [1])
    if not torch.cuda.is_available():
        assert torch_cli(argv[:-12] + ["--device", "cuda"]) != 0
